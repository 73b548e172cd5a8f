"""ark-serialize-0.2 wire formats for the KZG schemes' proofs and keys.

Port of the reference's `serialize/ark_schemes.py`. The codec machinery
(the spec language, `ArkSchemeCodec`'s walk, `ark_encode`/`ark_decode`) is
the reference's word for word, with two changes:

- `_schemas()` registers only the schemes the port has: KZG10's opening
  proof and Marlin's commitments, index info, keys and proof (PLONK's
  bytes, `schemes/plonk/serialize.py`, are built from these). Each
  discrete-log scheme (Spartan, Bulletproofs, Hyrax, Libra) adds its block
  when its slice comes, and with it the Ristretto and Edwards points
  behind `PT`: here `PT` is the pairing curve's G1.
- The port's Marlin keys carry a device: decoding gives them the codec's
  `device` (default "cuda"). The device is never written into the bytes.

The primitive encodings (ark-serialize 0.2):

- `Fp256/Fp384`: canonical (non-Montgomery) integer, little-endian, fixed
  width (32/48 bytes), empty flags in the top bits;
- `G1Affine/G2Affine`: compressed point with y-sign / infinity flags in the
  top byte (serialize/ark.py G1Codec/G2Codec);
- `Vec<T>`: u64 LE length + items; `DensePolynomial<F>` = its `coeffs` Vec;
- `usize`: u64 LE; `bool`: 1 byte; `Option<T>`: bool byte + payload if Some;
- tuples: components in order.

Each scheme's layout below cites the reference struct it mirrors. aSVC
derives no CanonicalSerialize in the reference (asvc/src/lib.rs:33-67 —
plain Clone/Eq), so it has none here.
"""

from __future__ import annotations

import functools
import io

from .ark import FieldCodec, G1Codec, G2Codec, read_u64, write_u64

# ---------------------------------------------------------------- spec language
FR = "fr"
PT = "pt"  # the scheme's group: pairing G1 or ristretto, by curve
G1 = "g1"
G2 = "g2"
U64 = "u64"
U32 = "u32"
BOOL = "bool"
POLY = ("vec", FR)  # DensePolynomial<F> == coeffs: Vec<F> (ascending)
# zkp_r1cs::Index: u8 tag (0 = Input, 1 = Aux) + usize (r1cs/src/lib.rs:76-84);
# framework entries are (coeff, kind 'I'|'A', index) tuples
ENTRY = ("entry",)
# BTreeMap<(u32, u32), Fr>: u64 len + sorted ((u32, u32), Fr) pairs
U32MAP_FR = ("u32map", FR)


def Vec(spec):
    return ("vec", spec)


def Opt(spec):
    return ("option", spec)


def Tup(*specs):
    return ("tuple", *specs)


def S(cls):
    return ("struct", cls)


# bulletproofs Proof keeps T_2..T_10 as a {degree: point} dict
# (reference: individual T_k fields, arithmetic_circuit.rs:163-183)
TDICT = ("tdict", (2, 3, 5, 6, 7, 8, 9, 10))


class ArkSchemeCodec:
    """Encode/decode registered scheme structs in ark-0.2 wire format.

    `curve` is a PairingCurve (PT == G1, compressed-with-flags); `device`
    is where decoded keys that hold one (Marlin's) run.
    """

    def __init__(self, curve, device="cuda"):
        self.curve = curve
        self.device = device
        self.fr = FieldCodec(curve.fr)
        self.g1 = G1Codec(curve)
        self.g2 = G2Codec(curve)

    # ------------- points -------------
    def _pt_bytes(self, v) -> bytes:
        return self.g1.to_bytes(v)

    def _pt_read(self, buf: io.BytesIO):
        return self.g1.read(buf)

    # ------------- generic walk -------------
    def _write(self, buf: io.BytesIO, spec, v) -> None:
        if spec == FR:
            buf.write(self.fr.to_bytes(v))
        elif spec == PT:
            buf.write(self._pt_bytes(v))
        elif spec == G1:
            buf.write(self.g1.to_bytes(v))
        elif spec == G2:
            buf.write(self.g2.to_bytes(v))
        elif spec == U64:
            write_u64(buf, v)
        elif spec == BOOL:
            buf.write(b"\x01" if v else b"\x00")
        elif spec[0] == "vec":
            write_u64(buf, len(v))
            for item in v:
                self._write(buf, spec[1], item)
        elif spec[0] == "option":
            if v is None:
                buf.write(b"\x00")
            else:
                buf.write(b"\x01")
                self._write(buf, spec[1], v)
        elif spec[0] == "tuple":
            assert len(v) == len(spec) - 1
            for s, item in zip(spec[1:], v):
                self._write(buf, s, item)
        elif spec[0] == "struct":
            fields, _ = _schema_for(spec[1])
            for name, s in fields:
                self._write(buf, s, getattr(v, name.lstrip("~")))
        elif spec[0] == "tdict":
            for k in spec[1]:
                buf.write(self._pt_bytes(v[k]))
        elif spec == U32:
            buf.write(int(v).to_bytes(4, "little"))
        elif spec[0] == "entry":
            coeff, kind, idx = v
            buf.write(self.fr.to_bytes(coeff))
            buf.write(b"\x00" if kind == "I" else b"\x01")
            write_u64(buf, idx)
        elif spec[0] == "u32map":
            items = sorted(v.items())
            write_u64(buf, len(items))
            for (i, j), val in items:
                buf.write(int(i).to_bytes(4, "little"))
                buf.write(int(j).to_bytes(4, "little"))
                self._write(buf, spec[1], val)
        else:
            raise ValueError(f"unknown spec {spec!r}")

    def _read(self, buf: io.BytesIO, spec):
        if spec == FR:
            return self.fr.read(buf)
        if spec == PT:
            return self._pt_read(buf)
        if spec == G1:
            return self.g1.read(buf)
        if spec == G2:
            return self.g2.read(buf)
        if spec == U64:
            return read_u64(buf)
        if spec == BOOL:
            b = buf.read(1)
            if b not in (b"\x00", b"\x01"):
                raise ValueError("invalid bool byte")
            return b == b"\x01"
        if spec[0] == "vec":
            n = read_u64(buf)
            return [self._read(buf, spec[1]) for _ in range(n)]
        if spec[0] == "option":
            return self._read(buf, spec[1]) if self._read(buf, BOOL) else None
        if spec[0] == "tuple":
            return tuple(self._read(buf, s) for s in spec[1:])
        if spec[0] == "struct":
            cls = spec[1]
            fields, extras = _schema_for(cls)
            kwargs = {}
            for name, s in fields:
                val = self._read(buf, s)
                if not name.startswith("~"):  # "~x": wire-only, not a ctor arg
                    kwargs[name] = val
            if extras is not None:
                kwargs.update(extras(self))
            return cls(**kwargs)
        if spec[0] == "tdict":
            return {k: self._pt_read(buf) for k in spec[1]}
        if spec == U32:
            raw = buf.read(4)
            if len(raw) != 4:
                raise ValueError("truncated u32")
            return int.from_bytes(raw, "little")
        if spec[0] == "entry":
            coeff = self.fr.read(buf)
            tag = buf.read(1)
            if tag not in (b"\x00", b"\x01"):
                raise ValueError("invalid Index tag")
            return (coeff, "I" if tag == b"\x00" else "A", read_u64(buf))
        if spec[0] == "u32map":
            n = read_u64(buf)
            out = {}
            for _ in range(n):
                i = int.from_bytes(buf.read(4), "little")
                j = int.from_bytes(buf.read(4), "little")
                out[(i, j)] = self._read(buf, spec[1])
            return out
        raise ValueError(f"unknown spec {spec!r}")

    # ------------- public API -------------
    def encode(self, value, spec=None) -> bytes:
        buf = io.BytesIO()
        self._write(buf, spec if spec is not None else S(type(value)), value)
        return buf.getvalue()

    def decode(self, data: bytes, spec) -> object:
        buf = io.BytesIO(data)
        out = self._read(buf, spec)
        if buf.read(1):
            raise ValueError("trailing bytes")
        return out


# ---------------------------------------------------------------- schemas
@functools.lru_cache(maxsize=1)
def _schemas():
    """class -> (ordered (name, spec) fields, extras(ctx) -> ctor kwargs)."""
    from ..schemes import kzg10
    from ..schemes.marlin import ahp as ma_ahp
    from ..schemes.marlin import marlin as ma
    from ..schemes.marlin import pc as ma_pc

    curve_extra = lambda ctx: {"curve": ctx.curve}  # noqa: E731
    device_extra = lambda ctx: {"curve": ctx.curve, "device": ctx.device}  # noqa: E731
    schemas = {}

    def add(cls, fields, extras=None):
        schemas[cls] = (tuple(fields), extras)

    # ---- marlin (marlin/src/data_structures.rs:11-47, pc/data_structures.rs:
    # 99-152, pc/kzg10.rs:65-67, ahp/indexer.rs:12-17) ----
    add(
        ma_pc.Commitment,
        [("comm", G1), ("shifted_comm", Opt(G1))],  # Comm is a G1 newtype
    )
    add(
        ma_ahp.IndexInfo,
        [
            ("num_constraints", U64),
            ("num_variables", U64),
            ("num_non_zeros", U64),
        ],
    )
    add(
        ma_pc.VerifierKey,
        [
            ("g", G1),
            ("gamma_g", G1),
            ("h", G2),
            ("beta_h", G2),
            ("supported_degree", U64),
        ],
        extras=curve_extra,
    )
    add(
        ma.IndexVerifierKey,
        [
            ("index_info", S(ma_ahp.IndexInfo)),
            ("index_comms", Vec(S(ma_pc.Commitment))),
            ("verifier_key", S(ma_pc.VerifierKey)),
        ],
        extras=device_extra,
    )
    # marlin's PC proof (pc/data_structures.rs:300-304)
    add(kzg10.OpenProof, [("w", G1), ("rand_v", Opt(FR))])
    add(
        ma.Proof,
        [
            ("commitments", Vec(Vec(S(ma_pc.Commitment)))),
            ("evaluations", Vec(FR)),
            ("opening_proofs", Vec(S(kzg10.OpenProof))),
        ],
    )

    return schemas


def _schema_for(cls):
    try:
        return _schemas()[cls]
    except KeyError:
        raise ValueError(f"no ark schema registered for {cls!r}") from None


def ark_encode(curve, value, spec=None) -> bytes:
    return ArkSchemeCodec(curve).encode(value, spec)


def ark_decode(curve, data: bytes, cls_or_spec, device="cuda"):
    spec = (
        S(cls_or_spec)
        if isinstance(cls_or_spec, type)
        else cls_or_spec
    )
    return ArkSchemeCodec(curve, device).decode(data, spec)
