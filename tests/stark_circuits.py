"""The STARK systems that `chip_smoke.py` proves on the card and that
tests/test_torch_starky.py holds against the JAX package on the CPU.

Each function takes the package by name, `"plonky2_tpu"` (JAX) or
`"plonky2_tpu_torch"` (the port), and imports that package's modules only,
so one seed gives one system in both and the port's callers load nothing of
JAX. The traces are numpy uint64 [columns, rows], made on the host:
- `fibonacci`: the reference's FibonacciStark from (0, 1), its public
  inputs (0, 1, fib(rows - 1));
- `wide_fibonacci`: `lanes` FibonacciStark lanes side by side (2 columns,
  5 constraints and 3 public inputs a lane), each started from seeded
  values; 64 lanes over 2^20 rows stand in for a zk_evm-width table;
- `ctl_system`: tests/test_ctl.py's two tables of one unconstrained column
  each, linked by one cross-table lookup (table 1 a rotation of table 0);
  `mismatch=True` breaks the multiset; `ctl_table0` proves table 0 alone
  from its own transcript, with the CTL challenges of the pair;
- `stark_verifier_circuit`: the plonky2 circuit that verifies a STARK proof
  (tests/test_starky_recursive.py's, seed 1234,
  `standard_recursion_config()`), unbuilt, with the proof's targets.
"""

import functools
import importlib

import numpy as np

SEED = 1234
P = (1 << 64) - (1 << 32) + 1
EPSILON = np.uint64((1 << 32) - 1)


def _starky(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.starky.{name}")


def fib(n: int, x0: int, x1: int) -> int:
    """x1 after n Fibonacci steps from (x0, x1), mod p."""
    for _ in range(n):
        x0, x1 = x1, (x0 + x1) % P
    return x1


def fibonacci(pkg: str, num_rows: int):
    """-> (stark, trace, public inputs)."""
    stark = _starky(pkg, "fibonacci_stark").FibonacciStark(num_rows)
    return stark, stark.generate_trace(0, 1), [0, 1, fib(num_rows - 1, 0, 1)]


def fibonacci_lanes(x0: np.ndarray, x1: np.ndarray, n: int) -> np.ndarray:
    """uint64 [n + 1, lanes]: s_0 = x0, s_1 = x1, s_{i+1} = s_i + s_{i-1}
    mod p, one pass over the rows for all lanes."""
    s = np.empty((n + 1, x0.shape[0]), dtype=np.uint64)
    s[0], s[1] = x0, x1
    with np.errstate(over="ignore"):
        for i in range(2, n + 1):
            a, b = s[i - 2], s[i - 1]
            c = a + b
            c[c < a] += EPSILON          # 2^64 = 2^32 - 1 (mod p)
            c[c >= P] -= np.uint64(P)
            s[i] = c
    return s


@functools.lru_cache(maxsize=None)
def wide_fibonacci_stark_class(pkg: str):
    base = _starky(pkg, "fibonacci_stark").FibonacciStark
    frame = _starky(pkg, "stark").EvaluationFrame

    class WideFibonacciStark(base):
        """`lanes` FibonacciStarks side by side: lane l owns columns
        2l, 2l + 1 and public inputs 3l..3l + 2, and adds its five
        constraints in FibonacciStark's order, lane by lane."""

        def __init__(self, lanes: int, num_rows: int):
            super().__init__(num_rows)
            self.lanes = lanes
            self.COLUMNS = 2 * lanes
            self.PUBLIC_INPUTS = 3 * lanes

        def eval(self, alg, f, consumer) -> None:
            for lane in range(self.lanes):
                c, p = slice(2 * lane, 2 * lane + 2), slice(3 * lane,
                                                            3 * lane + 3)
                base.eval(self, alg, frame(f.local_values[c],
                                           f.next_values[c],
                                           f.public_inputs[p]), consumer)

        def generate_trace(self, x0, x1) -> np.ndarray:
            """uint64 [2 lanes, num_rows] from the lanes' starting values."""
            s = fibonacci_lanes(np.asarray(x0, dtype=np.uint64),
                                np.asarray(x1, dtype=np.uint64),
                                self.num_rows)
            out = np.empty((2 * self.lanes, self.num_rows), dtype=np.uint64)
            out[0::2] = s[:-1].T
            out[1::2] = s[1:].T
            return out

    return WideFibonacciStark


def wide_fibonacci(pkg: str, lanes: int, num_rows: int, seed: int = SEED):
    """-> (stark, trace, public inputs): lane l starts from seeded
    (x0[l], x1[l]) and its public inputs are (x0, x1, its last x1)."""
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, P, size=lanes, dtype=np.uint64)
    x1 = rng.integers(0, P, size=lanes, dtype=np.uint64)
    stark = wide_fibonacci_stark_class(pkg)(lanes, num_rows)
    trace = stark.generate_trace(x0, x1)
    pis = []
    for lane in range(lanes):
        pis += [int(x0[lane]), int(x1[lane]), int(trace[2 * lane + 1, -1])]
    return stark, trace, pis


@functools.lru_cache(maxsize=None)
def shared_column_stark_class(pkg: str):
    stark = _starky(pkg, "stark").Stark

    class SharedColumnStark(stark):
        """One unconstrained column; the CTL is the whole statement."""
        COLUMNS = 1
        PUBLIC_INPUTS = 0

        def constraint_degree(self):
            # CTL transition constraint combine*(z-z')*z_last is degree 3
            return 3

        def requires_ctls(self):
            return True

        def eval(self, alg, frame, consumer):
            pass

    return SharedColumnStark


def ctls(pkg: str) -> list:
    """Table 0's column 0 looks up table 1's column 0."""
    ctl = _starky(pkg, "cross_table_lookup")
    column = _starky(pkg, "lookup").Column
    return [ctl.CrossTableLookup(
        looking_tables=(ctl.TableWithColumns(0, (column.single(0),)),),
        looked_table=ctl.TableWithColumns(1, (column.single(0),)),
    )]


def ctl_traces(num_rows: int, mismatch: bool = False):
    """Table 0 is 5, 6, ...; table 1 the same rotated by 3 (a permutation);
    with `mismatch`, table 1's first value is 999."""
    t0 = (np.uint64(5) + np.arange(num_rows, dtype=np.uint64))[None, :]
    t1 = np.roll(t0, 3, axis=1).copy()
    if mismatch:
        t1[0][0] = 999
    return t0, t1


def ctl_system(pkg: str, num_rows: int, mismatch: bool = False):
    """-> (starks, traces, ctls, public inputs) of prove_multi."""
    cls = shared_column_stark_class(pkg)
    return ([cls(), cls()], list(ctl_traces(num_rows, mismatch)), ctls(pkg),
            [[], []])


def ctl_table0(pkg: str, num_rows: int, config):
    """Table 0 of `ctl_system` proved from a fresh transcript of its own,
    with its CTL Z column built under the pair's CTL challenges (drawn after
    both trace caps), so one table's proof has the third FRI batch (its Z
    opened at x = 1) and checks alone. -> (stark, proof, (ctls, table,
    challenges))."""
    starks, traces, ctl_list, pis = ctl_system(pkg, num_rows)
    prover = _starky(pkg, "prover")
    cfg = config.fri_config
    challenger = importlib.import_module(f"{pkg}.iop.challenger").Challenger
    hashers = importlib.import_module(f"{pkg}.hash.hashers")
    oracle = importlib.import_module(f"{pkg}.fri.oracle").PolynomialBatch
    gc = hashers.PoseidonGoldilocksConfig
    ch = challenger(gc.hasher)
    if pkg == "plonky2_tpu":
        gf = importlib.import_module(f"{pkg}.field.goldilocks").GF
        ts = [gf.from_u64(t) for t in traces]
        caps = [oracle.from_values(t, cfg.rate_bits, False, cfg.cap_height,
                                   hasher=gc.hasher) for t in ts]
        kw = {}
    else:
        gl = importlib.import_module(f"{pkg}.field.goldilocks")
        ts = [gl.from_u64(t, "cpu") for t in traces]
        caps = [oracle.from_values(t, cfg.rate_bits, cfg.cap_height,
                                   gc.hasher) for t in ts]
        kw = {"device": "cpu"}
    for c in caps:
        ch.observe_cap(c.merkle_tree.cap_digests())
    challenges, data = _starky(pkg, "cross_table_lookup").get_ctl_data(
        config, ts, ctl_list, ch, 3)
    proof = prover.prove(starks[0], config, traces[0], pis[0],
                         ctl_data=data[0], ctl_challenges=challenges,
                         ctls=ctl_list, table=0, **kw)
    return starks[0], proof, (ctl_list, 0, challenges)


def stark_verifier_circuit(pkg: str, stark, config, degree_bits: int,
                           ctl=None):
    """-> (builder, proof targets): the proof's targets, the in-circuit
    STARK verifier over them, and its public inputs registered. `ctl` =
    (ctls, table, challenges) checks the table's CTL constraints with the
    challenges as constants, and its Z columns' openings at x = 1."""
    config_cls = importlib.import_module(f"{pkg}.plonk.config").CircuitConfig
    builder = importlib.import_module(f"{pkg}.plonk.circuit_builder") \
        .CircuitBuilder(config_cls.standard_recursion_config(), seed=SEED)
    rv = _starky(pkg, "recursive_verifier")
    if ctl is None:
        pt = rv.add_virtual_stark_proof_with_pis(builder, stark, config,
                                                 degree_bits)
        rv.verify_stark_proof_circuit(builder, stark, pt, config, degree_bits)
    else:
        ctl_mod = _starky(pkg, "cross_table_lookup")
        ctl_list, table, challenges = ctl
        max_degree = max(2, stark.constraint_degree())
        helpers, zs, per_ctl = ctl_mod.num_ctl_helpers_zs_all(
            ctl_list, table, config.num_challenges, max_degree)
        pt = rv.add_virtual_stark_proof_with_pis(
            builder, stark, config, degree_bits, num_ctl_helpers=helpers,
            num_ctl_zs=zs)
        o = pt.proof.openings
        num_lk = stark.num_lookup_helper_columns(config)
        chals = [(builder.constant_extension((b, 0)),
                  builder.constant_extension((g, 0))) for b, g in challenges]
        ctl_vars = ctl_mod.ctl_check_vars_single(
            table, list(zip(o.auxiliary_polys[num_lk:],
                            o.auxiliary_polys_next[num_lk:])),
            ctl_list, chals, per_ctl)
        rv.verify_stark_proof_circuit(
            builder, stark, pt, config, degree_bits, ctl_vars=ctl_vars,
            ctl_challenges_t=chals, num_ctl_helpers=helpers, num_ctl_zs=zs)
    builder.register_public_inputs(pt.public_inputs)
    return builder, pt
