"""secp256k1 ECDSA: native curve layer + circuit gadget layer
(reference: the `ecdsa` gadget crate)."""
