"""K6's fixed-base MSM (`cuda_rcb.rcb_fixed_base`; on CPU tensors its plain
version) against the JAX package's `_fixed_base_rcb` (the projective totals,
before normalization, limb for limb, on the same window table), and the
port's whole `fixed_base_msm` against the host ints, G1 and G2, at 67
points whose scalars come from a numpy seed with the edge scalars first: 0,
r - 1, a run of zero digits, every even digit zero, every digit 255. Also
the wrapper's refusal of non-CPU tensors and of tables and scalars of
another shape. Tolerance: none (canonical limbs, exact points)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.ops.msm import device_group as ref_device_group
from ckb_zkp_tpu_torch.host.pairing import get_curve as port_curve
from ckb_zkp_tpu_torch.ops import cuda_rcb
from ckb_zkp_tpu_torch.ops.limbs import to_numpy
from ckb_zkp_tpu_torch.ops.msm import device_group

torch.set_num_threads(1)
CURVE = get_curve("bn254")
PORT = port_curve("bn254")
R = CURVE.fr.modulus
N = 67


def _scalars(seed: int) -> list:
    """N scalars below r: the edge scalars, then uniform ones."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(N, 4), dtype=np.uint64)
    s = [sum(int(w) << (64 * j) for j, w in enumerate(row)) % R for row in words]
    digits_8_to_23 = ((1 << 128) - 1) << 64
    even_digits = sum(0xFF << (16 * k) for k in range(16))
    s[:5] = [0, R - 1, s[5] & ~digits_8_to_23, s[6] & ~even_digits, (0x30 << 248) - 1]
    assert all(0 <= x < R for x in s)
    return s


def _gen(dg):
    """The generator of dg's group, from the curve that dg was made with
    (a cached group may come from the JAX package's curve object)."""
    return dg.curve.g1_gen if dg.group == "g1" else dg.curve.g2_gen


def _aff(pts):
    return [(True, None, None) if p.infinity else (False, p.x, p.y) for p in pts]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_plain_matches_reference_projective(group):
    """The projective totals of `rcb_fixed_base` (plain, CPU) equal the
    reference's `_fixed_base_rcb` (its one-hot row selection and K6 a
    window) on the same table, limb for limb; the zero scalar is the
    identity (0 : 1 : 0)."""
    rdg = ref_device_group(CURVE, group)
    dg = device_group(PORT, group, "cpu")
    gen = CURVE.g1_gen if group == "g1" else CURVE.g2_gen
    table = dg.fixed_base_table(_gen(dg))
    rtable = rdg.fixed_base_table(gen)
    assert all(np.array_equal(to_numpy(t), np.asarray(jax.device_get(r)))
               for t, r in zip(table, rtable))
    sc = dg.encode_scalars(_scalars(7))
    got = cuda_rcb.rcb_fixed_base(dg.rg, table[0], table[1], sc)
    want = rdg._fixed_base_rcb(rtable, jnp.asarray(to_numpy(sc)))
    for g, w in zip(got, want):
        assert np.array_equal(to_numpy(g), np.asarray(jax.device_get(w)))
    ident = dg.rg.identity(())
    assert all(torch.equal(g[0], i) for g, i in zip(got, ident))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_msm_equals_host_ints(group):
    """The port's `fixed_base_msm` (one fixed-base launch, then one
    normalization) gives [s] base for every scalar, and its padding rows
    (zero scalars) are infinity."""
    dg = device_group(PORT, group, "cpu")
    gen = _gen(dg)
    scalars = _scalars(8)
    out = dg.fixed_base_msm(dg.fixed_base_table(gen), dg.encode_scalars(scalars),
                            pad_output=True)
    assert out[0].shape[0] == 128  # N padded to a power of two
    got = dg.decode_points_host(tuple(c[:N] for c in out))
    assert _aff(got) == _aff(dg.host_group.mul(gen, s) for s in scalars)
    assert not out[2][N:].any()


def test_fixed_base_wrapper_refuses_non_cpu_tensors_and_other_shapes():
    """The wrapper takes the plain version only for CPU tensors: any other
    tensor goes to the kernel, whose operand checks refuse a non-CUDA one.
    Tables must be (32, 256, *coord) and scalars (n, 16)."""
    dg = device_group(PORT, "g2", "cpu")
    X = torch.empty((32, 256, 2, 16), dtype=torch.int32, device="meta")
    sc = torch.empty((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rcb.rcb_fixed_base(dg.rg, X, X, sc)
    with pytest.raises(ValueError, match="table"):
        cuda_rcb.rcb_fixed_base(dg.rg, X[:16], X[:16], sc)
    with pytest.raises(ValueError, match="scalars"):
        cuda_rcb.rcb_fixed_base(dg.rg, X, X, sc[:, :8])
