"""Circom / Solidity verification-code export for gates (okx addition).

Reference: plonky2/src/gates/gate.rs:67-68 declares
export_circom_verification_code / export_solidity_verification_code, and each
gate hand-writes a template over GlExt* operations
(e.g. arithmetic_base.rs:75-98, circom side: circom/circuits/goldilocks.circom
GlExtAdd/GlExtSub/GlExtMul templates).

Gates here write their constraints once over an algebra
(`gates/gate.py`), so one generic exporter covers every gate: an emitting
algebra records each extension-field operation as a straight-line statement
(a fresh intermediate signal per op, so shared subexpressions stay linear
instead of exploding the expression tree), then wraps the program in the
reference's template shape. The output is string-equal to the JAX
package's (tests/test_torch_context_circom.py).
"""

from __future__ import annotations

from ..field import reference as ref


class _EmitAlgebra:
    """Algebra whose elements are signal names; ops append statements."""

    def __init__(self, emit_op):
        self._emit = emit_op        # (op, a, b) -> new name

    def add(self, a, b):
        return self._emit("add", a, b)

    def sub(self, a, b):
        return self._emit("sub", a, b)

    def mul(self, a, b):
        return self._emit("mul", a, b)

    def mul_const(self, a, c: int):
        return self._emit("mul", a, self.const(c))

    def add_const(self, a, c: int):
        return self._emit("add", a, self.const(c))

    def const(self, c: int):
        return self._emit("const", c % ref.ORDER, None)

    def zero(self):
        return self.const(0)


def _sanitize(gate_id: str) -> str:
    out = []
    for ch in gate_id:
        if ch.isalnum():
            out.append(ch)
        elif ch in "{}:,<>= ._+()":
            continue
        else:
            continue
    return "".join(out)[:64] or "Gate"


def export_circom_verification_code(gate) -> str:
    """Circom template evaluating the gate's filtered constraints
    (reference output shape: arithmetic_base.rs:75-98)."""
    lines: list[str] = []
    counter = [0]
    consts_cache: dict[int, str] = {}

    def emit(op, a, b):
        if op == "const":
            if a in consts_cache:
                return consts_cache[a]
            name = f"c_{len(consts_cache)}"
            lines.append(f"  signal {name}[2];")
            lines.append(f"  {name}[0] <== {a}; {name}[1] <== 0;")
            consts_cache[a] = name
            return name
        name = f"ev_{counter[0]}"
        counter[0] += 1
        fn = {"add": "GlExtAdd", "sub": "GlExtSub", "mul": "GlExtMul"}[op]
        lines.append(f"  signal {name}[2];")
        lines.append(f"  {name} <== {fn}()({a}, {b});")
        return name

    alg = _EmitAlgebra(emit)
    consts = [f"constants[$NUM_SELECTORS + {j}]"
              for j in range(gate.num_constants())]
    wires = [f"wires[{i}]" for i in range(gate.num_wires())]
    pi = [f"GlExt(public_input_hash[{k}], 0)()" for k in range(4)]
    constraints = gate.eval_unfiltered(alg, consts, wires, pi)

    name = _sanitize(gate.id())
    body = "\n".join(lines)
    pushes = "\n".join(
        f"  out[{k}] <== ConstraintPush()(constraints[{k}], filter, {c});"
        for k, c in enumerate(constraints))
    nc = gate.num_constraints()
    return f"""template {name}() {{
  signal input constants[NUM_OPENINGS_CONSTANTS()][2];
  signal input wires[NUM_OPENINGS_WIRES()][2];
  signal input public_input_hash[4];
  signal input constraints[NUM_GATE_CONSTRAINTS()][2];
  signal output out[NUM_GATE_CONSTRAINTS()][2];

  signal filter[2];
  $SET_FILTER;

{body}
{pushes}
  for (var i = {nc}; i < NUM_GATE_CONSTRAINTS(); i++) {{
    out[i] <== constraints[i];
  }}
}}"""


def export_vanishing_verifier_circom(common) -> str:
    """Whole-proof circom verifier core: ONE straight-line GlExt program
    computing the combined vanishing polynomial at zeta from a proof's
    openings — gate constraints (with selector filters), the permutation
    argument's partial-product checks, and the alpha combination — i.e. the
    algebraic heart of verifier.rs:78-95 emitted through the same abstract
    algebra the native and recursive verifiers run on. The reference ships
    the GlExt* leaf templates (circom/circuits/goldilocks.circom) and
    per-gate bodies; composing the full check is the okx pipeline's
    generated artifact, reproduced here generically.

    Inputs (all GlExt pairs unless noted): zeta, l0, constants[],
    wires[], plonk_zs[], plonk_zs_next[], partial_products[], sigmas[],
    betas[], gammas[], alphas[] (per-challenge), public_input_hash[4]
    (base-field). Outputs: out[num_challenges][2]."""
    from ..plonk.vanishing import eval_vanishing_poly

    lines: list[str] = []
    counter = [0]
    consts_cache: dict[int, str] = {}

    def emit(op, a, b):
        if op == "const":
            if a in consts_cache:
                return consts_cache[a]
            name = f"c_{len(consts_cache)}"
            lines.append(f"  signal {name}[2];")
            lines.append(f"  {name}[0] <== {a}; {name}[1] <== 0;")
            consts_cache[a] = name
            return name
        name = f"ev_{counter[0]}"
        counter[0] += 1
        fn = {"add": "GlExtAdd", "sub": "GlExtSub", "mul": "GlExtMul"}[op]
        lines.append(f"  signal {name}[2];")
        lines.append(f"  {name} <== {fn}()({a}, {b});")
        return name

    alg = _EmitAlgebra(emit)
    nc = common.config.num_challenges
    n_consts = common.num_constants
    n_wires = common.config.num_wires
    n_routed = common.config.num_routed_wires
    n_pp = common.num_partial_products
    consts = [f"constants[{j}]" for j in range(n_consts)]
    wires = [f"wires[{i}]" for i in range(n_wires)]
    pi = [f"GlExt(public_input_hash[{k}], 0)()" for k in range(4)]
    zs = [f"plonk_zs[{i}]" for i in range(nc)]
    zs_next = [f"plonk_zs_next[{i}]" for i in range(nc)]
    pps = [f"partial_products[{i}]" for i in range(nc * n_pp)]
    sigmas = [f"sigmas[{j}]" for j in range(n_routed)]
    betas = [f"betas[{i}]" for i in range(nc)]
    gammas = [f"gammas[{i}]" for i in range(nc)]
    alphas = [f"alphas[{i}]" for i in range(nc)]

    outs = eval_vanishing_poly(alg, common, "zeta", consts, wires, pi,
                               zs, zs_next, pps, sigmas, betas, gammas,
                               alphas, "l0")
    body = "\n".join(lines)
    pushes = "\n".join(f"  out[{i}] <== {o};" for i, o in enumerate(outs))
    return f"""template VanishingAtZeta() {{
  signal input zeta[2];
  signal input l0[2];
  signal input constants[{n_consts}][2];
  signal input wires[{n_wires}][2];
  signal input plonk_zs[{nc}][2];
  signal input plonk_zs_next[{nc}][2];
  signal input partial_products[{nc * n_pp}][2];
  signal input sigmas[{n_routed}][2];
  signal input betas[{nc}][2];
  signal input gammas[{nc}][2];
  signal input alphas[{nc}][2];
  signal input public_input_hash[4];
  signal output out[{nc}][2];

{body}
{pushes}
}}"""


def evaluate_circom_program(code: str, bindings: dict) -> dict:
    """Execute an emitted straight-line GlExt program with ext2 semantics
    (the python evaluation of the circom templates' Goldilocks arithmetic,
    reference circom/circuits/goldilocks.circom GlExtAdd/Sub/Mul).

    bindings maps input-signal array names to lists of ext2 pairs (or ints
    for base-field inputs like public_input_hash). Returns {out_index:
    ext2 pair} for the template's `out[i] <== name;` assignments."""
    import re

    env: dict = {}

    def val(expr):
        expr = expr.strip()
        m = re.fullmatch(r"(\w+)\[(\d+)\]", expr)
        if m and m.group(1) in bindings:
            v = bindings[m.group(1)][int(m.group(2))]
            return tuple(v) if isinstance(v, (tuple, list)) else (v, 0)
        m = re.fullmatch(r"GlExt\((\w+)\[(\d+)\], 0\)\(\)", expr)
        if m:
            return (int(bindings[m.group(1)][int(m.group(2))]) % ref.ORDER,
                    0)
        if expr == "zeta" or expr == "l0":
            v = bindings[expr]
            return tuple(v)
        return env[expr]

    outs: dict = {}
    for line in code.splitlines():
        line = line.strip()
        m = re.fullmatch(r"(c_\d+)\[0\] <== (\d+); \1\[1\] <== 0;", line)
        if m:
            env[m.group(1)] = (int(m.group(2)), 0)
            continue
        m = re.fullmatch(
            r"(ev_\d+) <== (GlExtAdd|GlExtSub|GlExtMul)\(\)\((.+)\);",
            line)
        if m:
            name, op, args = m.groups()
            # split at the single top-level comma (args may nest GlExt(..))
            depth = 0
            for k, ch in enumerate(args):
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                elif ch == "," and depth == 0:
                    a, b = args[:k], args[k + 1:]
                    break
            fn = {"GlExtAdd": ref.ext2_add, "GlExtSub": ref.ext2_sub,
                  "GlExtMul": ref.ext2_mul}[op]
            env[name] = fn(val(a), val(b))
            continue
        m = re.fullmatch(r"out\[(\d+)\] <== (\S+);", line)
        if m:
            outs[int(m.group(1))] = val(m.group(2))
    return outs


def export_solidity_verification_code(gate) -> str:
    """Solidity library evaluating the gate's filtered constraints
    (reference output shape: arithmetic_base.rs:99-120)."""
    lines: list[str] = []
    counter = [0]

    def emit(op, a, b):
        if op == "const":
            return f"GoldilocksExtLib.from(uint64({a}))"
        name = f"ev_{counter[0]}"
        counter[0] += 1
        fn = {"add": "add", "sub": "sub", "mul": "mul"}[op]
        lines.append(f"        uint64[2] memory {name} = {a}.{fn}({b});")
        return name

    alg = _EmitAlgebra(emit)
    consts = [f"ev.constants[$NUM_SELECTORS + {j}]"
              for j in range(gate.num_constants())]
    wires = [f"ev.wires[{i}]" for i in range(gate.num_wires())]
    pi = [f"GoldilocksExtLib.from(ev.public_input_hash[{k}])"
          for k in range(4)]
    constraints = gate.eval_unfiltered(alg, consts, wires, pi)

    name = _sanitize(gate.id())
    body = "\n".join(lines)
    pushes = "\n".join(
        f"        GatesUtilsLib.push(constraints, ev.filter, {k}, {c});"
        for k, c in enumerate(constraints))
    return f"""library {name}Lib {{
    using GoldilocksExtLib for uint64[2];
    function set_filter(GatesUtilsLib.EvaluationVars memory ev) internal pure {{
        $SET_FILTER;
    }}
    function eval(GatesUtilsLib.EvaluationVars memory ev, uint64[2][$NUM_GATE_CONSTRAINTS] memory constraints) internal pure {{
{body}
{pushes}
    }}
}}"""
