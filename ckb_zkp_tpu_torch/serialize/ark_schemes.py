"""ark-serialize-0.2 wire formats for the KZG schemes' proofs and keys.

Port of the reference's `serialize/ark_schemes.py`. The codec machinery
(the spec language, `ArkSchemeCodec`'s walk, `ark_encode`/`ark_decode`) is
the reference's word for word, with two changes:

- `_schemas()` registers the schemes the port has: KZG10's opening
  proof, Marlin's commitments, index info, keys and proof (PLONK's bytes,
  `schemes/plonk/serialize.py`, are built from these), Spartan's
  parameters, R1CS instance, SPARK encoding and proofs (NIZK and SNARK),
  Bulletproofs' generators, dense R1CS and proofs, the setup parameters
  and sigma protocols that Libra and Hyrax share, Libra's zk-GKR proof
  and Hyrax's proof. `PT` is the pairing curve's G1, for curve25519 the
  32-byte Ristretto encoding, and for jubjub and baby jubjub
  (`host/edwards_groups.py`) the compressed twisted Edwards point.
- The port's Marlin keys carry a device: decoding gives them the codec's
  `device` (default "cuda"). The device is never written into the bytes.
- Three fast paths with the generic walk's bytes and errors: Spartan's
  R1CS matrices (`MATRIX`) and the dense Fr matrices (`DENSE`, the rows of
  Bulletproofs' R1CS, 3 n (n + 2) elements for n constraints) in one pass
  over the bytes, and a vector of DEVICE_DECODE_MIN or more compressed G1
  points with its square roots as one batch on the codec's `device`
  (`_g1_read_many`), where `G1Codec.read` pays two Python-int
  exponentiations a point.

The primitive encodings (ark-serialize 0.2):

- `Fp256/Fp384`: canonical (non-Montgomery) integer, little-endian, fixed
  width (32/48 bytes), empty flags in the top bits;
- `G1Affine/G2Affine`: compressed point with y-sign / infinity flags in the
  top byte (serialize/ark.py G1Codec/G2Codec); `Curve25519Point`: 32-byte
  ristretto encoding (ckb-zkp curve25519/src/group.rs:293-338);
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

from ..host.curves import AffinePoint
from .ark import (FLAG_INFINITY, FLAG_POSITIVE_Y, FieldCodec, G1Codec, G2Codec, read_u64,
                  write_u64)

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
# an R1CS matrix, Vec<Vec<(Fr, Index)>> (spartan/src/r1cs.rs)
MATRIX = ("vec", ("vec", ENTRY))
# a dense Fr matrix, Vec<Vec<Fr>> (bulletproofs' CL/CR/CO)
DENSE = ("vec", ("vec", FR))
# compressed G1 points in a vector from which their square roots run on the
# codec's device as one batch
DEVICE_DECODE_MIN = 1 << 10


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

    `curve` is a PairingCurve (PT == G1, compressed-with-flags), the
    Curve25519 registry entry (PT == 32-byte ristretto) or an Edwards
    registry entry (PT == compressed y with the x-sign flag); `device` is where
    decoded keys that hold one (Marlin's) run.
    """

    def __init__(self, curve, device="cuda"):
        self.curve = curve
        self.device = device
        self.fr = FieldCodec(curve.fr)
        self.is_ristretto = getattr(curve, "name", "") == "curve25519"
        self.is_edwards = getattr(curve, "is_edwards", False)
        if not (self.is_ristretto or self.is_edwards):
            self.g1 = G1Codec(curve)
            self.g2 = G2Codec(curve)

    # ------------- points -------------
    def _pt_bytes(self, v) -> bytes:
        if self.is_ristretto:
            return v.encode()
        if self.is_edwards:
            # ark-0.2 twisted Edwards compressed: y with x-sign flag
            return self.curve.g1.point_to_bytes(v)
        return self.g1.to_bytes(v)

    def _pt_read(self, buf: io.BytesIO):
        if self.is_ristretto:
            from ..host.ristretto import RistrettoPoint

            raw = buf.read(32)
            if len(raw) != 32:
                raise ValueError("truncated ristretto point")
            pt = RistrettoPoint.decode(raw)
            if pt is None:
                raise ValueError("invalid ristretto encoding")
            return pt
        if self.is_edwards:
            g = self.curve.g1
            raw = buf.read(g._nbytes)
            if len(raw) != g._nbytes:
                raise ValueError("truncated edwards point")
            pt = g.point_from_bytes(raw)
            if pt is None:
                raise ValueError("invalid edwards encoding")
            return pt
        return self.g1.read(buf)

    # ------------- generic walk -------------
    def _matrix_bytes(self, m) -> bytes:
        """`MATRIX`'s bytes in one pass (the walk's: row lengths, then each
        entry's coefficient, Index tag and index)."""
        p, nb = self.fr.spec.modulus, self.fr.nbytes
        memo: dict = {}
        parts = [len(m).to_bytes(8, "little")]
        put = parts.append
        for row in m:
            put(len(row).to_bytes(8, "little"))
            for coeff, kind, idx in row:
                c = memo.get(coeff)
                if c is None:
                    c = memo[coeff] = (coeff % p).to_bytes(nb, "little")
                put(c)
                put(b"\x00" if kind == "I" else b"\x01")
                put(int(idx).to_bytes(8, "little"))
        return b"".join(parts)

    def _matrix_read(self, buf: io.BytesIO):
        """`MATRIX` from the buffer in one pass over its bytes, with the
        walk's results: a short u64 reads as what is there, a short or
        non-canonical coefficient and a bad tag raise ValueError."""
        data = buf.getvalue()
        end, o = len(data), buf.tell()
        p, nb = self.fr.spec.modulus, self.fr.nbytes
        frm = int.from_bytes
        n = frm(data[o : o + 8], "little")
        o = min(o + 8, end)
        rows = []
        for _ in range(n):
            k = frm(data[o : o + 8], "little")
            o = min(o + 8, end)
            row = []
            for _ in range(k):
                if o + nb > end:
                    raise ValueError("truncated field element")
                coeff = frm(data[o : o + nb], "little")
                if coeff >= p:
                    raise ValueError("non-canonical field element")
                tag = data[o + nb] if o + nb < end else None
                if tag != 0 and tag != 1:
                    raise ValueError("invalid Index tag")
                o += nb + 1
                row.append((coeff, "A" if tag else "I", frm(data[o : o + 8], "little")))
                o = min(o + 8, end)
            rows.append(row)
        buf.seek(o)
        return rows

    def _dense_bytes(self, m) -> bytes:
        """`DENSE`'s bytes in one pass (the walk's: the row count, then each
        row's length and its elements), zero elements as zero bytes."""
        p, nb = self.fr.spec.modulus, self.fr.nbytes
        parts = [len(m).to_bytes(8, "little")]
        for row in m:
            raw = bytearray(len(row) * nb)
            for j, v in enumerate(row):
                if v:
                    raw[j * nb : (j + 1) * nb] = (v % p).to_bytes(nb, "little")
            parts += (len(row).to_bytes(8, "little"), raw)
        return b"".join(parts)

    def _dense_read(self, buf: io.BytesIO):
        """`DENSE` from the buffer in one pass over its bytes, with the
        walk's results: a short u64 reads as what is there, and a row's
        first non-canonical element before its first short one raises
        "non-canonical", else the short one "truncated"."""
        import numpy as np

        data = buf.getvalue()
        end, o = len(data), buf.tell()
        p, nb = self.fr.spec.modulus, self.fr.nbytes
        frm = int.from_bytes
        n = frm(data[o : o + 8], "little")
        o = min(o + 8, end)
        rows = []
        for _ in range(n):
            k = frm(data[o : o + 8], "little")
            o = min(o + 8, end)
            full = min(k, (end - o) // nb)
            raw = np.frombuffer(data, np.uint8, full * nb, o).reshape(full, nb)
            row = [0] * full
            for j in raw.any(axis=1).nonzero()[0].tolist():
                v = frm(data[o + j * nb : o + (j + 1) * nb], "little")
                if v >= p:
                    raise ValueError("non-canonical field element")
                row[j] = v
            if full < k:
                raise ValueError("truncated field element")
            o += k * nb
            rows.append(row)
        buf.seek(o)
        return rows

    def _g1_read_many(self, buf: io.BytesIO, n: int) -> list:
        """n compressed G1 points, as `G1Codec.read` gives them: the
        coordinates and flags read on the host, y = rhs^((q + 1) / 4) for
        rhs = x^3 + b as one batch on `self.device` (K1 through
        `DeviceField.pow_fixed`; q = 3 mod 4 on the pairing curves), an x
        whose rhs has no root raising ValueError."""
        from ..ops.field import device_field

        q = self.curve.fq.modulus
        coords = [self.g1._coord_read(buf) for _ in range(n)]
        fin = [x for x, flags in coords if not flags & FLAG_INFINITY]
        ys = rs = []
        if fin:
            df = device_field(self.curve.fq, self.device)
            X = df.encode(fin)
            rhs = df.add(df.mul(df.sqr(X), X), df.const(self.curve.g1.b, (len(fin),)))
            ys, rs = df.decode(df.pow_fixed(rhs, (q + 1) // 4)), df.decode(rhs)
        out, it = [], iter(zip(ys, rs))
        for x, flags in coords:
            if flags & FLAG_INFINITY:
                out.append(self.g1.group.infinity)
                continue
            y, r = next(it)
            if y * y % q != r:
                raise ValueError("x not on curve")
            if (y > q - y) != bool(flags & FLAG_POSITIVE_Y):
                y = -y % q
            out.append(AffinePoint(x, y))
        return out

    def _write(self, buf: io.BytesIO, spec, v) -> None:
        if spec == MATRIX:
            buf.write(self._matrix_bytes(v))
        elif spec == DENSE:
            buf.write(self._dense_bytes(v))
        elif spec == FR:
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
        if spec == MATRIX:
            return self._matrix_read(buf)
        if spec == DENSE:
            return self._dense_read(buf)
        if spec in (("vec", G1), ("vec", PT)) and not (self.is_ristretto or self.is_edwards):
            n = read_u64(buf)
            if n >= DEVICE_DECODE_MIN:
                return self._g1_read_many(buf, n)
            return [self.g1.read(buf) for _ in range(n)]
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
    from ..schemes.bulletproofs import arithmetic_circuit as bp_ac
    from ..schemes.bulletproofs import inner_product_proof as bp_ipp
    from ..schemes.hyrax import hyrax_proof as hy
    from ..schemes.hyrax import params as sigma  # shared by libra + hyrax
    from ..schemes.hyrax import zk_sumcheck as hy_zk
    from ..schemes.libra import zk_linear_gkr as li
    from ..schemes.marlin import ahp as ma_ahp
    from ..schemes.marlin import marlin as ma
    from ..schemes.marlin import pc as ma_pc
    from ..schemes.spartan import common as sp_common
    from ..schemes.spartan import nizk as sp
    from ..schemes.spartan import snark as sp_sn

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

    # ---- spartan setup/verify keys (spartan/src/data_structure.rs:11-166,
    # lib.rs:43-166, r1cs.rs:15-22, spark.rs EncodeCommit) ----
    MC = S(sp_common.MultiCommitmentParameters)
    PC = S(sp_common.PolyCommitmentParameters)
    add(
        sp_common.MultiCommitmentParameters,
        [("n", U64), ("generators", Vec(PT)), ("h", PT)],
    )
    add(
        sp_common.PolyCommitmentParameters,
        [("n", U64), ("gen_n", MC), ("gen_1", MC)],
    )
    add(
        sp_common.SumCheckCommitmentParameters,
        [("gen_1", MC), ("gen_3", MC), ("gen_4", MC)],
    )
    add(
        sp_common.R1CSSatisfiedParameters,
        [
            ("pc_params", PC),
            ("sc_params", S(sp_common.SumCheckCommitmentParameters)),
            ("n", U64),
        ],
    )
    add(
        sp_common.NizkParameters,
        [("r1cs_satisfied_params", S(sp_common.R1CSSatisfiedParameters))],
    )
    add(
        sp_sn.R1CSEvalsParameters,
        [("ops_params", PC), ("mem_params", PC), ("derefs_params", PC)],
    )
    add(  # reference field order: eval params FIRST (data_structure.rs:81-84)
        sp_sn.SnarkParameters,
        [
            ("r1cs_eval_params", S(sp_sn.R1CSEvalsParameters)),
            ("r1cs_satisfied_params", S(sp_common.R1CSSatisfiedParameters)),
        ],
    )
    add(
        sp.R1CSInstance,
        [
            ("num_inputs", U64),
            ("num_aux", U64),
            ("num_constraints", U64),
            ("a_matrix", MATRIX),
            ("b_matrix", MATRIX),
            ("c_matrix", MATRIX),
        ],
        extras=curve_extra,
    )
    add(
        sp_sn.EncodeCommit,
        [
            ("n", U64),
            ("m", U64),
            ("ops_commit", Vec(PT)),
            ("mem_commit", Vec(PT)),
        ],
    )
    # ---- spartan setup artifacts: the CLI universal_setup files are the
    # CanonicalSerialize bytes of snark::Parameters / nizk::Parameters
    # (reference cli/src/setup.rs:47-72, lib.rs:43-48,151-154,
    # data_structure.rs:118-165) ----
    add(
        sp_sn.AddrTimestamps,
        [
            ("addr_index", Vec(Vec(U64))),
            ("addrs", Vec(Vec(FR))),
            ("read_ts_list", Vec(Vec(FR))),
            ("audit_ts", Vec(FR)),
        ],
    )
    add(
        sp_sn.EncodeMemory,
        [
            ("row_addr_ts", S(sp_sn.AddrTimestamps)),
            ("col_addr_ts", S(sp_sn.AddrTimestamps)),
            ("val_list", Vec(Vec(FR))),
            ("ops_list", Vec(FR)),
            ("mem_list", Vec(FR)),
        ],
    )
    add(
        sp_sn.SnarkSetup,
        [
            ("params", S(sp_sn.SnarkParameters)),
            ("r1cs", S(sp.R1CSInstance)),
            ("encode", S(sp_sn.EncodeMemory)),
            ("encode_commit", S(sp_sn.EncodeCommit)),
        ],
    )

    # ---- spartan (spartan/src/data_structure.rs:168-339) ----
    add(sp_common.InnerProductProof, [("l_vec", Vec(PT)), ("r_vec", Vec(PT))])
    add(
        sp.SumCheckEvalProof,
        [
            ("d_commit", PT),
            ("dot_cd_commit", PT),
            ("z", Vec(FR)),
            ("z_delta", FR),
            ("z_beta", FR),
        ],
    )
    add(
        sp.SumCheckProof,
        [
            ("comm_polys", Vec(PT)),
            ("comm_evals", Vec(PT)),
            ("proofs", Vec(S(sp.SumCheckEvalProof))),
        ],
    )
    add(sp.KnowledgeProof, [("t_commit", PT), ("z1", FR), ("z2", FR)])
    add(
        sp.ProductProof,
        [
            ("commit_alpha", PT),
            ("commit_beta", PT),
            ("commit_delta", PT),
            ("z", Vec(FR)),
        ],
    )
    add(sp.EqProof, [("alpha", PT), ("z", FR)])
    add(
        sp.DotProductProof,
        [
            ("inner_product_proof", S(sp_common.InnerProductProof)),
            ("delta", PT),
            ("beta", PT),
            ("z1", FR),
            ("z2", FR),
        ],
    )
    add(
        sp.KnowledgeProductCommit,
        [
            ("va_commit", PT),
            ("vb_commit", PT),
            ("vc_commit", PT),
            ("prod_commit", PT),
        ],
    )
    add(
        sp.KnowledgeProductProof,
        [
            ("knowledge_proof", S(sp.KnowledgeProof)),
            ("product_proof", S(sp.ProductProof)),
        ],
    )
    add(
        sp.R1CSSatProof,
        [
            ("commit_witness", Vec(PT)),
            ("proof_one", S(sp.SumCheckProof)),
            ("proof_two", S(sp.SumCheckProof)),
            ("w_ry", FR),
            ("product_proof", S(sp.DotProductProof)),
            ("knowledge_product_commit", S(sp.KnowledgeProductCommit)),
            ("knowledge_product_proof", S(sp.KnowledgeProductProof)),
            ("sc1_eq_proof", S(sp.EqProof)),
            ("sc2_eq_proof", S(sp.EqProof)),
            ("commit_ry", PT),
        ],
    )
    add(
        sp.NIZKProof,
        [
            ("r1cs_satisfied_proof", S(sp.R1CSSatProof)),
            ("r", Tup(Vec(FR), Vec(FR))),
        ],
    )
    add(
        sp_sn.LayerProductCircuitProof,
        [
            ("polys", Vec(POLY)),
            ("claim_prod_left", Vec(FR)),
            ("claim_prod_right", Vec(FR)),
        ],
    )
    add(
        sp_sn.ProductCircuitEvalProof,
        [
            ("layers_proof", Vec(S(sp_sn.LayerProductCircuitProof))),
            ("claim_dotp", Tup(Vec(FR), Vec(FR), Vec(FR))),
        ],
    )
    add(
        sp_sn.ProductLayerProof,
        [
            ("proof_memory", S(sp_sn.ProductCircuitEvalProof)),
            ("proof_ops", S(sp_sn.ProductCircuitEvalProof)),
            ("eval_dotp", Tup(Vec(FR), Vec(FR))),
            ("eval_row", Tup(FR, Vec(FR), Vec(FR), FR)),
            ("eval_col", Tup(FR, Vec(FR), Vec(FR), FR)),
        ],
    )
    add(
        sp_sn.HashLayerProof,
        [
            ("proof_derefs", S(sp.DotProductProof)),
            ("proof_ops", S(sp.DotProductProof)),
            ("proof_mem", S(sp.DotProductProof)),
            ("evals_derefs", Tup(Vec(FR), Vec(FR))),
            ("evals_row", Tup(Vec(FR), Vec(FR), FR)),
            ("evals_col", Tup(Vec(FR), Vec(FR), FR)),
            ("evals_val", Vec(FR)),
        ],
    )
    add(
        sp_sn.R1CSEvalsProof,
        [
            ("prod_layer_proof", S(sp_sn.ProductLayerProof)),
            ("hash_layer_proof", S(sp_sn.HashLayerProof)),
            ("derefs_commit", Vec(PT)),
        ],
    )
    add(
        sp_sn.SNARKProof,
        [
            ("r1cs_satisfied_proof", S(sp.R1CSSatProof)),
            ("matrix_evals", Tup(FR, FR, FR)),
            ("r1cs_evals_proof", S(sp_sn.R1CSEvalsProof)),
        ],
    )

    # ---- bulletproofs (arithmetic_circuit.rs:104-183, inner_product_proof.rs:14-20) ----
    add(
        bp_ac.Generators,
        [
            ("g_vec_N", Vec(PT)),
            ("h_vec_N", Vec(PT)),
            ("g", PT),
            ("h", PT),
            ("u", PT),
            ("n", U64),
            ("N", U64),
            ("k", U64),
            ("n_w", U64),
        ],
    )
    add(  # the _T maps are derived from the dense rows (matrix_to_map)
        bp_ac.R1csCircuit,
        [
            ("CL", DENSE),
            ("CR", DENSE),
            ("CO", DENSE),
            ("~CL_T", U32MAP_FR),
            ("~CR_T", U32MAP_FR),
            ("~CO_T", U32MAP_FR),
        ],
    )
    add(
        bp_ipp.Proof,
        [("L_vec", Vec(PT)), ("R_vec", Vec(PT)), ("a", FR), ("b", FR)],
    )
    add(
        bp_ac.Proof,
        [
            ("A_I", PT),
            ("A_O", PT),
            ("A_W", PT),
            ("S", PT),
            ("T", TDICT),  # T_2,T_3,T_5..T_10 individual fields in the reference
            ("mu", FR),
            ("tau_x", FR),
            ("l_x", Vec(FR)),
            ("r_x", Vec(FR)),
            ("t_x", FR),
            ("IPP", S(bp_ipp.Proof)),
            ("IPP_P", PT),
        ],
    )

    # ---- libra + hyrax setup params (libra/src/params.rs:11-14,
    # hyrax/src/params.rs:11-14: sc_params then pc_params) ----
    add(
        sigma.SumCheckCommitmentSetupParameters,
        [("gen_1", MC), ("gen_3", MC), ("gen_4", MC)],
    )
    for _params_cls in (sigma.Parameters, li.Parameters):
        add(
            _params_cls,
            [
                ("sc_params", S(sigma.SumCheckCommitmentSetupParameters)),
                ("pc_params", PC),
            ],
            extras=curve_extra,
        )

    # ---- libra + hyrax shared sigma protocols (libra/src/commitment.rs:12-486,
    # hyrax/src/commitment.rs — identical layouts) ----
    add(sigma.EqProof, [("alpha", PT), ("z", FR)])
    add(
        sigma.ProductProof,
        [
            ("comm_alpha", PT),
            ("comm_beta", PT),
            ("comm_delta", PT),
            ("z", Vec(FR)),
        ],
    )
    add(sigma.BulletReduceProof, [("l_vec", Vec(PT)), ("r_vec", Vec(PT))])
    add(
        sigma.LogDotProductProof,
        [
            ("bullet_reduce_proof", S(sigma.BulletReduceProof)),
            ("delta", PT),
            ("beta", PT),
            ("z1", FR),
            ("z2", FR),
        ],
    )

    # ---- libra zk-GKR (libra/src/libra_zk_linear_gkr.rs:17-39, sumcheck.rs:176-436) ----
    add(
        li.SumCheckEvalProof,
        [
            ("d_commit", PT),
            ("dot_cd_commit", PT),
            ("z", Vec(FR)),
            ("z_delta", FR),
            ("z_beta", FR),
        ],
    )
    add(
        li.ZKSumCheckProof,
        [
            ("comm_polys", Vec(PT)),
            ("comm_evals", Vec(PT)),
            ("proofs", Vec(S(li.SumCheckEvalProof))),
        ],
    )
    add(
        li.ZKLayerProof,
        [
            ("proof_phase_one", S(li.ZKSumCheckProof)),
            ("proof_phase_two", S(li.ZKSumCheckProof)),
            ("comm_x", PT),
            ("comm_y", PT),
            ("comm_z", PT),
            ("prod_proof", S(sigma.ProductProof)),
            ("eq_proof", S(sigma.EqProof)),
        ],
    )
    add(
        li.ZKLinearGKRProof,
        [
            ("comm_witness", Vec(PT)),
            ("proofs", Vec(S(li.ZKLayerProof))),
            ("prod_proof0", S(sigma.LogDotProductProof)),
            ("comm_y0", PT),
            ("eq_proof0", S(sigma.EqProof)),
            ("prod_proof1", S(sigma.LogDotProductProof)),
            ("comm_y1", PT),
            ("eq_proof1", S(sigma.EqProof)),
        ],
    )

    # ---- hyrax (hyrax/src/hyrax_proof.rs:16-26, zk_sumcheck_proof.rs:18-32) ----
    add(
        hy_zk.ZkSumcheckProof,
        [
            ("prod_proof", S(sigma.ProductProof)),
            ("comm_a0", PT),
            ("comm_c", PT),
            ("comm_x", PT),
            ("comm_y", PT),
            ("comm_z", PT),
            ("comm_polys", Vec(PT)),
            ("comm_evals", Vec(PT)),
            ("comm_deltas", Vec(PT)),
            ("z_vec", Vec(FR)),
            ("z_delta_vec", Vec(FR)),
            ("zc", FR),
        ],
    )
    add(
        hy.HyraxProof,
        [
            ("comm_witness", Vec(PT)),
            ("proofs", Vec(S(hy_zk.ZkSumcheckProof))),
            ("prod_proof0", S(sigma.LogDotProductProof)),
            ("comm_y0", PT),
            ("eq_proof0", S(sigma.EqProof)),
            ("prod_proof1", S(sigma.LogDotProductProof)),
            ("comm_y1", PT),
            ("eq_proof1", S(sigma.EqProof)),
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
