"""EcGFp5: elliptic curve over GF(p^5) with Schnorr signatures
(reference: the `ecgfp5` gadget crate)."""
