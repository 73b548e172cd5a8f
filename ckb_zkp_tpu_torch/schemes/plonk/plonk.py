"""PLONK AHP + top-level setup/keygen/prove/verify.

Port of the reference's `schemes/plonk/plonk.py` (ckb-zkp
plonk/src/{lib.rs:54-290, ahp/, rng.rs, utils.rs}), word for word apart
from the device: `setup` and `index` take it, `keygen` takes it from the
SRS's tensors and `prove` from the prover key; the `VerifierKey` carries
it (not serialized) for the verifier's `HDomain`. The commitments and
openings are the port's Marlin `pc` (RCB MSMs on the device, one
`msm_many` a commit or batch opening); the transforms above
`HDomain.HOST_SIZE` run on the device. The host loops stay as the
reference has them: round 2's accumulator (one inverse a gate), round 3's
quotient (4n steps) and the index's 4n inverses of the vanishing poly.
`keygen` and `prove` take a `timings` dict, as the port's Marlin does.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass

import torch

from ...host import poly as hpoly
from ...host.pairing import PairingCurve
from ...ops.hdomain import HDomain
from ...serialize.tobytes import fr_bytes
from ...transcript import ChaChaRng
from ..errors import SchemeError
from ..groth16.prover import Stages
from ..marlin import pc
from .composer import Composer

LABELS = ["w_0", "w_1", "w_2", "w_3", "z", "t_0", "t_1", "t_2", "t_3"]
INDEX_LABELS = [
    "q_0", "q_1", "q_2", "q_3", "q_m", "q_c", "q_arith",
    "sigma_0", "sigma_1", "sigma_2", "sigma_3",
]


def default_ks(p: int) -> list[int]:
    return [1, 7, 13, 17]


class Blake2sFsRng:
    """Digest-chained ChaCha FS-RNG (reference rng.rs, D = Blake2s)."""

    def __init__(self, seed_material: bytes):
        self.seed = hashlib.blake2s(seed_material).digest()
        self.r = ChaChaRng(self.seed)

    def absorb(self, material: bytes):
        self.seed = hashlib.blake2s(material + self.seed).digest()
        self.r = ChaChaRng(self.seed)

    def rand_fr(self, p: int) -> int:
        bits = p.bit_length()
        n64 = (bits + 63) // 64
        shave = n64 * 64 - bits
        mask = (1 << (n64 * 64 - shave)) - 1
        while True:
            v = int.from_bytes(self.r.next_bytes(n64 * 8), "little") & mask
            if v < p:
                return v


@dataclass
class LC:
    label: str
    terms: list[tuple[int, str]]  # (coeff, poly label); 'one' for constants


@dataclass
class IndexInfo:
    n: int
    ks: list[int]


@dataclass
class Index:
    info: IndexInfo
    polys: dict[str, list[int]]  # label -> coeffs (selectors + sigmas)
    evals_n: dict[str, list[int]]  # label -> evals on domain n
    evals_4n: dict[str, list[int]]  # label -> coset evals on domain 4n
    l1_4n: list[int]
    v_4n_inv: list[int]
    domain_n: HDomain
    domain_4n: HDomain


@dataclass
class VerifierKey:
    curve: PairingCurve
    comms: dict[str, pc.Commitment]
    rk: pc.VerifierKey
    info: IndexInfo
    device: torch.device | str = "cuda"


@dataclass
class ProverKey:
    vk: VerifierKey
    index: Index
    rands: dict[str, pc.Randomness]
    ck: pc.CommitterKey


@dataclass
class Proof:
    commitments: list[list[pc.Commitment]]
    evaluations: list[int]
    pc_proofs: list


class Plonk:
    PROTOCOL_NAME = b"PLONK"

    @staticmethod
    def setup(curve: PairingCurve, max_degree: int, rng: random.Random, device="cuda"):
        return pc.setup(curve, max_degree, rng, device)

    # ------------- indexer -------------
    @staticmethod
    def index(curve: PairingCurve, cs: Composer, ks: list[int], device="cuda") -> Index:
        p = curve.fr.modulus
        domain_n = HDomain(curve.fr, cs.size(), device)
        domain_4n = HDomain(curve.fr, 4 * domain_n.size, device)
        n = domain_n.size
        roots = domain_n.elements
        sel, sigmas = cs.compose(roots, ks)
        polys, evals_n, evals_4n = {}, {}, {}
        for k in ("q_0", "q_1", "q_2", "q_3", "q_m", "q_c", "q_arith"):
            evals_n[k] = sel[k]
            polys[k] = domain_n.ifft(sel[k])
            evals_4n[k] = domain_4n.coset_fft(polys[k])
        for w, k in enumerate(("sigma_0", "sigma_1", "sigma_2", "sigma_3")):
            evals_n[k] = sigmas[w]
            polys[k] = domain_n.ifft(sigmas[w])
            evals_4n[k] = domain_4n.coset_fft(polys[k])
        # vanishing poly of domain n evaluated on the 4n coset, inverted
        v_poly = [(-1) % p] + [0] * (n - 1) + [1]
        v_4n = domain_4n.coset_fft(v_poly)
        v_4n_inv = [pow(v, -1, p) for v in v_4n]
        l1_poly = domain_n.ifft([1] + [0] * (n - 1))
        l1_4n = domain_4n.coset_fft(l1_poly)
        return Index(
            info=IndexInfo(n=n, ks=list(ks)),
            polys=polys,
            evals_n=evals_n,
            evals_4n=evals_4n,
            l1_4n=l1_4n,
            v_4n_inv=v_4n_inv,
            domain_n=domain_n,
            domain_4n=domain_4n,
        )

    @staticmethod
    def keygen(curve, srs: pc.UniversalParams, cs: Composer, ks: list[int],
               timings: dict | None = None):
        """`timings`, when given, receives the seconds of the index and of
        its commitments."""
        device = srs.powers_of_g[0].device
        st = Stages(timings, device)
        index = Plonk.index(curve, cs, ks, device)
        st.mark("index")
        if srs.max_degree < 4 * index.info.n:
            raise SchemeError("circuit too large for srs")
        ck, rk = pc.trim(srs, 4 * index.info.n)
        labeled = [pc.LabeledPolynomial(l, index.polys[l]) for l in INDEX_LABELS]
        comms, rands = pc.commit(ck, labeled, None)
        st.mark("commit")
        vk = VerifierKey(
            curve=curve,
            comms={c.label: c.commitment for c in comms},
            rk=rk,
            info=index.info,
            device=device,
        )
        pk = ProverKey(
            vk=vk, index=index, rands={l: r for l, r in zip(INDEX_LABELS, rands)}, ck=ck
        )
        return pk, vk

    # ------------- helpers -------------
    @staticmethod
    def _eval_l1(p, n, zeta):
        num = (pow(zeta, n, p) - 1) % p
        den = pow(n * (zeta - 1) % p, -1, p)
        return num * den % p

    @staticmethod
    def _construct_lcs(curve, info: IndexInfo, domain_n: HDomain,
                       beta, gamma, alpha, zeta, get_eval) -> list[LC]:
        p = curve.fr.modulus
        ks = info.ks
        lcs = [LC(l, [(1, l)]) for l in ("w_0", "w_1", "w_2", "w_3", "z",
                                          "sigma_0", "sigma_1", "sigma_2", "q_arith")]
        zeta_n = pow(zeta, info.n, p)
        zeta_2n = zeta_n * zeta_n % p
        lcs.append(LC("t", [(1, "t_0"), (zeta_n, "t_1"), (zeta_2n, "t_2"),
                            (zeta_n * zeta_2n % p, "t_3")]))
        w0z = get_eval("w_0", zeta)
        w1z = get_eval("w_1", zeta)
        w2z = get_eval("w_2", zeta)
        w3z = get_eval("w_3", zeta)
        g = domain_n.elements[1] if domain_n.size > 1 else 1
        zsz = get_eval("z", zeta * g % p)
        s0z = get_eval("sigma_0", zeta)
        s1z = get_eval("sigma_1", zeta)
        s2z = get_eval("sigma_2", zeta)
        qaz = get_eval("q_arith", zeta)
        arith_terms = [
            (qaz * w0z % p, "q_0"),
            (qaz * w1z % p, "q_1"),
            (qaz * w2z % p, "q_2"),
            (qaz * w3z % p, "q_3"),
            (qaz * w1z % p * w2z % p, "q_m"),
            (qaz, "q_c"),
        ]
        numerator = 1
        for wz, k in zip((w0z, w1z, w2z, w3z), ks):
            numerator = numerator * ((wz + k * beta % p * zeta + gamma) % p) % p
        denumerator = (
            (w0z + beta * s0z + gamma) % p
            * ((w1z + beta * s1z + gamma) % p) % p
            * ((w2z + beta * s2z + gamma) % p) % p
            * beta % p * zsz % p
        )
        l1_zeta = Plonk._eval_l1(p, info.n, zeta)
        alpha2 = alpha * alpha % p
        perm_terms = [
            ((numerator * alpha + l1_zeta * alpha2) % p, "z"),
            ((-denumerator * alpha) % p, "sigma_3"),
        ]
        lcs.append(LC("r", arith_terms + perm_terms))
        lcs.sort(key=lambda lc: lc.label)
        return lcs

    @staticmethod
    def _query_set(p, domain_n: HDomain, zeta):
        g = domain_n.elements[1] if domain_n.size > 1 else 1
        qs = {(l, zeta) for l in ("w_0", "w_1", "w_2", "w_3",
                                   "sigma_0", "sigma_1", "sigma_2", "q_arith", "t", "r")}
        qs.add(("z", zeta * g % p))
        return qs

    # ------------- prover -------------
    @staticmethod
    def prove(curve, pk: ProverKey, cs: Composer, zk_rng: random.Random,
              timings: dict | None = None) -> Proof:
        """`timings`, when given, receives the seconds of each round's host
        work (its transforms included) and commitments, of the
        evaluations and of the batch opening."""
        p = curve.fr.modulus
        index = pk.index
        dn, d4 = index.domain_n, index.domain_4n
        st = Stages(timings, dn.device)
        n = index.info.n
        ks = index.info.ks
        public_inputs = cs.public_inputs()
        fs = Blake2sFsRng(
            Plonk.PROTOCOL_NAME + b"".join(fr_bytes(curve, x) for x in public_inputs)
        )
        pi_n = public_inputs + [0] * (n - len(public_inputs))
        pi_poly = dn.ifft(pi_n)
        pi_4n = d4.coset_fft(pi_poly)

        # round 1: wire polynomials
        w_n = cs.synthesize(n)
        w_polys = {k: dn.ifft(v) for k, v in w_n.items()}
        w_4n = {k: d4.coset_fft(v) for k, v in w_polys.items()}
        first_lp = [pc.LabeledPolynomial(k, w_polys[k]) for k in ("w_0", "w_1", "w_2", "w_3")]
        st.mark("round1_host")
        first_comms, first_rands = pc.commit(pk.ck, first_lp, zk_rng)
        st.mark("round1_commit")
        fs.absorb(b"".join(pc.commitment_bytes(curve, c.commitment) for c in first_comms))
        beta = fs.rand_fr(p)
        gamma = fs.rand_fr(p)

        # round 2: permutation accumulator z
        roots = dn.elements
        sig_n = {k: index.evals_n[k] for k in ("sigma_0", "sigma_1", "sigma_2", "sigma_3")}
        perms = []
        for i in range(n):
            num = den = 1
            for w, k in zip(("w_0", "w_1", "w_2", "w_3"), ks):
                num = num * ((w_n[w][i] + k * beta % p * roots[i] + gamma) % p) % p
            for w, sk in zip(("w_0", "w_1", "w_2", "w_3"),
                             ("sigma_0", "sigma_1", "sigma_2", "sigma_3")):
                den = den * ((w_n[w][i] + beta * sig_n[sk][i] + gamma) % p) % p
            perms.append(num * pow(den, -1, p) % p)
        z = [1]
        for i in range(n - 1):
            z.append(z[-1] * perms[i] % p)
        assert z[-1] * perms[-1] % p == 1, "permutation argument broken"
        z_poly = dn.ifft(z)
        z_4n = d4.coset_fft(z_poly)
        second_lp = [pc.LabeledPolynomial("z", z_poly)]
        st.mark("round2_host")
        second_comms, second_rands = pc.commit(pk.ck, second_lp, zk_rng)
        st.mark("round2_commit")
        fs.absorb(b"".join(pc.commitment_bytes(curve, c.commitment) for c in second_comms))
        alpha = fs.rand_fr(p)

        # round 3: quotient
        size4 = d4.size
        e4 = index.evals_4n
        linear_4n = d4.coset_fft([0, 1])
        alpha2 = alpha * alpha % p
        t = []
        for i in range(size4):
            # arithmetic part
            qa = e4["q_arith"][i]
            t_arith = 0
            if qa:
                t_arith = (
                    e4["q_0"][i] * w_4n["w_0"][i]
                    + e4["q_1"][i] * w_4n["w_1"][i]
                    + e4["q_2"][i] * w_4n["w_2"][i]
                    + e4["q_3"][i] * w_4n["w_3"][i]
                    + e4["q_m"][i] * w_4n["w_1"][i] % p * w_4n["w_2"][i]
                    + e4["q_c"][i]
                    + pi_4n[i]
                ) % p * qa % p
            # permutation part
            nxt = i % 4 if i // 4 == (size4 // 4 - 1) else i + 4
            num = den = 1
            for w, k in zip(("w_0", "w_1", "w_2", "w_3"), ks):
                num = num * ((w_4n[w][i] + k * beta % p * linear_4n[i] + gamma) % p) % p
            for w, sk in zip(("w_0", "w_1", "w_2", "w_3"),
                             ("sigma_0", "sigma_1", "sigma_2", "sigma_3")):
                den = den * ((w_4n[w][i] + beta * e4[sk][i] + gamma) % p) % p
            t_perm = (
                (num * z_4n[i] - den * z_4n[nxt]) % p * alpha
                + (z_4n[i] - 1) % p * index.l1_4n[i] % p * alpha2
            ) % p
            t.append((t_arith + t_perm) % p * index.v_4n_inv[i] % p)
        t_poly = d4.coset_ifft(t)
        t_chunks = [t_poly[i * n : (i + 1) * n] for i in range(4)]
        while len(t_chunks) < 4:
            t_chunks.append([0])
        third_lp = [
            pc.LabeledPolynomial(f"t_{i}", hpoly.trim(c) if c else [0])
            for i, c in enumerate(t_chunks)
        ]
        st.mark("round3_host")
        third_comms, third_rands = pc.commit(pk.ck, third_lp, zk_rng)
        st.mark("round3_commit")
        fs.absorb(b"".join(pc.commitment_bytes(curve, c.commitment) for c in third_comms))
        zeta = fs.rand_fr(p)

        # evaluations + opening
        all_polys = {l: index.polys[l] for l in INDEX_LABELS}
        for lp in first_lp + second_lp + third_lp:
            all_polys[lp.label] = lp.coeffs
        all_rands = dict(pk.rands)
        for lp, r in zip(first_lp + second_lp + third_lp,
                         list(first_rands) + list(second_rands) + list(third_rands)):
            all_rands[lp.label] = r

        def poly_eval_label(label, point):
            return hpoly.evaluate(all_polys[label], point, p)

        lcs = Plonk._construct_lcs(
            curve, index.info, dn, beta, gamma, alpha, zeta, poly_eval_label
        )
        qs = Plonk._query_set(p, dn, zeta)
        lc_by_label = {lc.label: lc for lc in lcs}

        def lc_poly(lc: LC) -> list[int]:
            out = [0]
            for coeff, term in lc.terms:
                out = hpoly.add(out, hpoly.scale(all_polys[term], coeff, p), p)
            return out

        def lc_rand(lc: LC) -> pc.Randomness:
            rand = [0]
            for coeff, term in lc.terms:
                r = all_rands[term].rand
                if r:
                    rand = hpoly.add(rand, hpoly.scale(r, coeff, p), p)
            return pc.Randomness(rand=rand if hpoly.trim(rand) != [0] else [])

        evals = []
        for label, point in sorted(qs):
            evals.append((label, hpoly.evaluate(lc_poly(lc_by_label[label]), point, p)))
        evals.sort(key=lambda x: x[0])
        evaluations = [e for _, e in evals]
        fs.absorb(b"".join(fr_bytes(curve, e) for e in evaluations))
        epsilon = fs.rand_fr(p)
        st.mark("evaluations")

        lc_polys = {l: pc.LabeledPolynomial(l, lc_poly(lc)) for l, lc in lc_by_label.items()}
        lc_rands = {l: lc_rand(lc) for l, lc in lc_by_label.items()}
        pc_proofs = pc.batch_open(
            pk.ck,
            [lc_polys[l] for l in sorted(lc_polys)],
            qs,
            epsilon,
            [lc_rands[l] for l in sorted(lc_polys)],
        )
        st.mark("batch_open")
        return Proof(
            commitments=[
                [c.commitment for c in first_comms],
                [c.commitment for c in second_comms],
                [c.commitment for c in third_comms],
            ],
            evaluations=evaluations,
            pc_proofs=pc_proofs,
        )

    # ------------- verifier -------------
    @staticmethod
    def verify(curve, vk: VerifierKey, public_inputs: list[int], proof: Proof) -> bool:
        p = curve.fr.modulus
        g1 = curve.g1
        n = vk.info.n
        dn = HDomain(curve.fr, n, vk.device)
        fs = Blake2sFsRng(
            Plonk.PROTOCOL_NAME + b"".join(fr_bytes(curve, x) for x in public_inputs)
        )
        fs.absorb(b"".join(pc.commitment_bytes(curve, c) for c in proof.commitments[0]))
        beta = fs.rand_fr(p)
        gamma = fs.rand_fr(p)
        fs.absorb(b"".join(pc.commitment_bytes(curve, c) for c in proof.commitments[1]))
        alpha = fs.rand_fr(p)
        fs.absorb(b"".join(pc.commitment_bytes(curve, c) for c in proof.commitments[2]))
        zeta = fs.rand_fr(p)

        qs = Plonk._query_set(p, dn, zeta)
        fs.absorb(b"".join(fr_bytes(curve, e) for e in proof.evaluations))
        epsilon = fs.rand_fr(p)

        labels_sorted = sorted(l for l, _ in qs)
        evaluations = {}
        for (label, point), e in zip(
            sorted(((l, pt) for l, pt in qs), key=lambda x: x[0]), proof.evaluations
        ):
            evaluations[(label, point)] = e

        def get_eval(label, point):
            key = (label, point)
            if key not in evaluations:
                raise SchemeError(f"missing evaluation {label}")
            return evaluations[key]

        # equality check
        g = dn.elements[1] if n > 1 else 1
        v_zeta = (pow(zeta, n, p) - 1) % p
        pi_n = list(public_inputs) + [0] * (n - len(public_inputs))
        pi_poly = dn.ifft(pi_n)
        pi_zeta = hpoly.evaluate(pi_poly, zeta, p)
        l1_zeta = Plonk._eval_l1(p, n, zeta)
        alpha2 = alpha * alpha % p
        w0 = get_eval("w_0", zeta)
        w1 = get_eval("w_1", zeta)
        w2 = get_eval("w_2", zeta)
        w3 = get_eval("w_3", zeta)
        zs = get_eval("z", zeta * g % p)
        s0 = get_eval("sigma_0", zeta)
        s1 = get_eval("sigma_1", zeta)
        s2 = get_eval("sigma_2", zeta)
        qa = get_eval("q_arith", zeta)
        t_z = get_eval("t", zeta)
        r_z = get_eval("r", zeta)
        lhs = t_z * v_zeta % p
        rhs = (
            r_z
            + qa * pi_zeta
            - zs
            * ((w0 + beta * s0 + gamma) % p)
            * ((w1 + beta * s1 + gamma) % p)
            % p
            * ((w2 + beta * s2 + gamma) % p)
            % p
            * ((w3 + gamma) % p)
            % p
            * alpha
            - l1_zeta * alpha2
        ) % p
        if lhs != rhs:
            return False

        # pc check over linear combinations
        all_comms = dict(vk.comms)
        for lbl, c in zip(("w_0", "w_1", "w_2", "w_3"), proof.commitments[0]):
            all_comms[lbl] = c
        all_comms["z"] = proof.commitments[1][0]
        for i, c in enumerate(proof.commitments[2]):
            all_comms[f"t_{i}"] = c
        lcs = Plonk._construct_lcs(curve, vk.info, dn, beta, gamma, alpha, zeta, get_eval)
        lc_comms = {}
        for lc in lcs:
            acc = g1.infinity
            for coeff, term in lc.terms:
                acc = g1.add(acc, g1.mul(all_comms[term].comm, coeff))
            lc_comms[lc.label] = pc.LabeledCommitment(lc.label, pc.Commitment(acc))
        return pc.batch_check(
            vk.rk,
            [lc_comms[l] for l in sorted(lc_comms)],
            qs,
            evaluations,
            proof.pc_proofs,
            epsilon,
        )
