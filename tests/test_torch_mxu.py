"""The tensor-core Montgomery reduction and the MXU probes' plain kernels
against the JAX package, on the CPU: the port's band constants against the
reference's `mxu_band_consts` and `_band_matmul`, the plain byte-band
multiply against `_mont_mul_rows_mxu` and `_mont_mul_rows` (run eagerly on
(8, 128) tiles), and the plain P14 and P15 against the bodies of
`scripts/probe_mxu.py` (loaded with `ast`, without running its `main()`).
Eager JAX only; everything is compared bit for bit."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.ops import pallas_field
from ckb_zkp_tpu_torch.ops import cuda_probe, mont_tc
from ckb_zkp_tpu_torch.ops.field import DeviceField
from ckb_zkp_tpu_torch.ops.limbs import ints_to_limbs

torch.set_num_threads(1)
CURVE = get_curve("bn254")
DF = DeviceField(CURVE.fq, "cpu")
P_LIMBS = tuple(int(v) for v in DF.p_limbs)
NP_LIMBS = tuple(int(v) for v in DF.nprime_limbs)
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "probe_mxu.py")


def _script_bodies():
    """`vpu_kernel`, `mxu_kernel` and the constants SB, LANES, K_OPS of
    scripts/probe_mxu.py, compiled alone (the script runs main() on import)."""
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    keep = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef) and node.name in ("vpu_kernel", "mxu_kernel"))
            or (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) in ("SB", "LANES", "K_OPS"))]
    ns = {"jax": jax, "jnp": jnp, "np": np}
    exec(compile(ast.Module(body=keep, type_ignores=[]), SCRIPT, "exec"), ns)
    assert {"vpu_kernel", "mxu_kernel", "SB", "LANES", "K_OPS"} <= set(ns)
    return ns


@pytest.mark.parametrize("sb", [8, 32])
def test_band_consts_match_reference(sb):
    want = pallas_field.mxu_band_consts(P_LIMBS, NP_LIMBS, sb)
    got = mont_tc.mxu_band_consts(DF.p_limbs, DF.nprime_limbs, sb)
    for w, g in zip(want[:2], got[:2]):
        assert w.dtype == g.dtype and np.array_equal(w, g)
    assert got[2:] == want[2:]


def test_card_band_column_sums_equal_band_matmul():
    """The card form (u8 bytes, no kron, no -128) gives `_band_matmul`'s
    column sums on random bytes, for both bands; and the fragment table
    holds the card form's rows where the mma's A layout puts them."""
    m1b, m2b, rs1, rs2 = pallas_field.mxu_band_consts(P_LIMBS, NP_LIMBS, 8)
    M1, M2 = mont_tc.band_matrices(DF.p_limbs, DF.nprime_limbs)
    rng = np.random.default_rng(5)
    tiles = rng.integers(0, 256, (32, 8, 128), dtype=np.int32)
    flat = torch.as_tensor(tiles.reshape(32, -1).T.astype(np.int64))  # (1024, 32)
    for mb, rs, M in ((m1b, rs1, M1), (m2b, rs2, M2)):
        want = pallas_field._band_matmul(jnp.asarray(mb), [jnp.asarray(t) for t in tiles],
                                         rs, M.shape[0])
        got = mont_tc.exact_matmul(flat, torch.as_tensor(M.astype(np.int64)))
        assert np.array_equal(np.stack([np.asarray(w).reshape(-1) for w in want]),
                              got.T.numpy())
    tab = mont_tc.fragment_table(DF.p_limbs, DF.nprime_limbs)
    rows = np.concatenate([M1, M2])
    lane = 4 * 3 + 2  # group 3, tq 2
    assert tab[0, lane, 0] == int.from_bytes(bytes(rows[3, 8:12]), "little")
    assert tab[5, lane, 3] == int.from_bytes(bytes(rows[80 + 11, 24:28]), "little")


def _canonical_tiles(seed):
    rng = np.random.default_rng(seed)
    p = DF.spec.modulus
    vals = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(8 * 128)]
    vals[:4] = [0, 1, p - 1, DF.R]
    return ints_to_limbs(vals, DF.L)  # (1024, 16) uint32


@pytest.mark.parametrize("nmul", [1, 4])
def test_plain_tc_mul_equals_reference_mxu_and_cios(nmul):
    a, b = _canonical_tiles(1), _canonical_tiles(2)
    m1, m2, rs1, rs2 = pallas_field.mxu_band_consts(P_LIMBS, NP_LIMBS, 8)
    m1, m2 = jnp.asarray(m1), jnp.asarray(m2)
    tiles = lambda x: [jnp.asarray(x[:, k].reshape(8, 128)) for k in range(DF.L)]  # noqa: E731
    ra, rb = tiles(a), tiles(b)
    rc = list(ra)
    for _ in range(nmul):
        ra = pallas_field._mont_mul_rows_mxu(ra, rb, P_LIMBS, NP_LIMBS, m1, m2, rs1, rs2)
        rc = pallas_field._mont_mul_rows(rc, rb, P_LIMBS, NP_LIMBS)
    want = np.stack([np.asarray(t).reshape(-1) for t in ra], axis=1)
    assert np.array_equal(want, np.stack([np.asarray(t).reshape(-1) for t in rc], axis=1))
    ta, tb = (torch.as_tensor(x.astype(np.int32)) for x in (a, b))
    for red in cuda_probe.REDS:
        got = cuda_probe.mul_chain(DF, ta, tb, nmul, red)
        assert np.array_equal(got.numpy().astype(np.uint32), want), red


def test_plain_p14_equals_script_vpu_kernel():
    ns = _script_bodies()
    assert ns["K_OPS"] == cuda_probe.K_OPS
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1 << 32, (2, ns["SB"], ns["LANES"]), dtype=np.uint32)
    for op in cuda_probe.U32_OPS:
        o = np.zeros_like(x)
        with np.errstate(over="ignore"):
            ns["vpu_kernel"](op, x, o)
        got = cuda_probe.u32_ops(torch.as_tensor(x.view(np.int32)), op)
        assert np.array_equal(got.numpy().view(np.uint32), o), op


def test_plain_p15_equals_script_mxu_kernel():
    ns = _script_bodies()
    sb, lanes = ns["SB"], ns["LANES"]
    assert (32 * sb, lanes) == (cuda_probe.MM_ROWS, cuda_probe.MM_LANES)
    m2d = cuda_probe.band_mma_matrix("cpu")
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (32, 2 * sb, lanes), dtype=np.uint32)
    x[:, :, :3] = rng.integers(0, 1 << 32, (32, 2 * sb, 3), dtype=np.uint32)
    want = np.zeros_like(x)
    for i in range(2):
        o = np.zeros((32, sb, lanes), np.uint32)
        ns["mxu_kernel"](8, m2d.numpy(), x[:, i * sb:(i + 1) * sb], o)
        want[:, i * sb:(i + 1) * sb] = o
    got = cuda_probe.band_mma(m2d, torch.as_tensor(x.view(np.int32)), 8)
    assert np.array_equal(got.numpy().view(np.uint32), want)
