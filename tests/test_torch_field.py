"""The port's field (K1's plain version), Fq2 and limb converters against the
reference's DeviceField/DeviceFq2 (XLA on the CPU), its Pallas row math and
the host ints. Tolerance: none, every comparison is bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.ops.ec import DeviceFq2 as RefFq2
from ckb_zkp_tpu.ops.field import device_field as ref_device_field
from ckb_zkp_tpu.ops.pallas_field import _mont_mul_rows
from ckb_zkp_tpu_torch.ops import limbs as tl
from ckb_zkp_tpu_torch.ops.cuda_field import mont_mul, mont_mul_plain
from ckb_zkp_tpu_torch.ops.ec import DeviceFq2
from ckb_zkp_tpu_torch.ops.field import DeviceField

torch.set_num_threads(1)
CURVE = get_curve("bn254")


def _values(spec, n, seed):
    """n field elements from a numpy seed, led by 0, 1, p - 1 and R mod p."""
    p = spec.modulus
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
    xs = [sum(int(w) << (64 * i) for i, w in enumerate(row)) % p for row in raw]
    xs[:4] = [0, 1, p - 1, (1 << 256) % p]
    return xs


def _ref(arr):
    return np.asarray(jax.device_get(arr))


@pytest.mark.parametrize("fieldsel", ["fr", "fq"])
def test_field_ops_match_reference_and_host(fieldsel):
    spec = getattr(CURVE, fieldsel)
    p = spec.modulus
    ref = ref_device_field(spec)
    f = DeviceField(spec, "cpu")
    xs, ys = _values(spec, 64, 1), _values(spec, 64, 2)[::-1]
    A_np, B_np = np.asarray(ref.encode(xs)), np.asarray(ref.encode(ys))
    A, B = tl.to_torch(A_np, "cpu"), tl.to_torch(B_np, "cpu")
    assert np.array_equal(tl.to_numpy(f.encode(xs)), A_np)
    for name in ("mul", "add", "sub"):
        got = tl.to_numpy(getattr(f, name)(A, B))
        assert np.array_equal(got, _ref(getattr(ref, name)(A_np, B_np))), name
    assert np.array_equal(tl.to_numpy(f.neg(A)), _ref(ref.neg(A_np)))
    assert np.array_equal(tl.to_numpy(f.sqr(A)), _ref(ref.sqr(A_np)))
    assert np.array_equal(tl.to_numpy(f.from_mont(A)), _ref(ref.from_mont(A_np)))
    raw = tl.to_torch(tl.ints_to_limbs(xs, f.L), "cpu")
    assert torch.equal(f.to_mont(raw), A)
    assert f.decode(f.mul(A, B)) == [x * y % p for x, y in zip(xs, ys)]
    assert f.decode(f.inv(A[:6])) == [pow(x, -1, p) if x else 0 for x in xs[:6]]
    assert f.decode(f.pow_fixed(A[:6], 5)) == [pow(x, 5, p) for x in xs[:6]]
    assert f.is_zero(A).tolist() == [x == 0 for x in xs]
    assert f.decode(f.const(7, (2,))) == [7, 7]
    assert torch.equal(f.ones((3,)), f.encode([1, 1, 1]))


@pytest.mark.parametrize("fieldsel", ["fr", "fq"])
def test_k1_plain_matches_pallas_rows(fieldsel):
    spec = getattr(CURVE, fieldsel)
    ref = ref_device_field(spec)
    f = DeviceField(spec, "cpu")
    A_np = np.asarray(ref.encode(_values(spec, 64, 3)))
    B_np = np.asarray(ref.encode(_values(spec, 64, 4)))
    out = _mont_mul_rows(
        [jnp.asarray(A_np.T[i]) for i in range(f.L)],
        [jnp.asarray(B_np.T[i]) for i in range(f.L)],
        tuple(int(v) for v in ref.p_limbs),
        tuple(int(v) for v in ref.nprime_limbs),
    )
    want = _ref(jnp.stack(out, axis=0).T)
    got = mont_mul_plain(f, tl.to_torch(A_np, "cpu"), tl.to_torch(B_np, "cpu"))
    assert np.array_equal(tl.to_numpy(got), want)
    # the wrapper takes the plain version for CPU tensors, with broadcasting
    one = f.ones(())
    A = tl.to_torch(A_np, "cpu")
    assert torch.equal(mont_mul(f, A, one), A)


def test_k1_wrapper_refuses_non_cpu_tensors_without_a_kernel():
    f = DeviceField(CURVE.fq, "cpu")
    a = torch.empty((4, f.L), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mont_mul(f, a, a)


def test_fq2_matches_reference():
    fq = ref_device_field(CURVE.fq)
    ref2 = RefFq2(fq)
    f2 = DeviceFq2(DeviceField(CURVE.fq, "cpu"))
    xs = _values(CURVE.fq, 64, 5)
    ys = _values(CURVE.fq, 64, 6)[::-1]
    A_np = np.asarray(fq.encode(xs)).reshape(32, 2, fq.L)
    B_np = np.asarray(fq.encode(ys)).reshape(32, 2, fq.L)
    A, B = tl.to_torch(A_np, "cpu"), tl.to_torch(B_np, "cpu")
    assert np.array_equal(tl.to_numpy(f2.mul(A, B)), _ref(ref2.mul(A_np, B_np)))
    assert np.array_equal(tl.to_numpy(f2.add(A, B)), _ref(ref2.add(A_np, B_np)))
    assert np.array_equal(tl.to_numpy(f2.sub(A, B)), _ref(ref2.sub(A_np, B_np)))
    assert np.array_equal(tl.to_numpy(f2.inv(A[4:8])), _ref(ref2.inv(A_np[4:8])))
    assert f2.is_zero(A).tolist() == _ref(ref2.is_zero(A_np)).tolist()


def test_limb_converters_round_trip():
    p = CURVE.fq.modulus
    xs = _values(CURVE.fq, 16, 7)
    arr = tl.ints_to_limbs(xs, 16)
    assert arr.dtype == np.uint32 and tl.limbs_to_ints(arr) == xs
    t = tl.to_torch(arr, "cpu")
    assert t.dtype == torch.int32 and np.array_equal(tl.to_numpy(t), arr)
    assert tl.limbs_to_ints(t) == xs
    assert tl.limbs_to_ints(tl.int_to_limbs(p - 1, 16)[None]) == [p - 1]
    words = tl.pack_limbs(t)
    want = (arr[:, 0::2] | (arr[:, 1::2] << 16)).astype(np.uint32)
    assert np.array_equal(words.numpy().view(np.uint32), want)
    assert torch.equal(tl.unpack_words(words).to(torch.int32), t)
