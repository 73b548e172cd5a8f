"""The port stands alone: it runs without ever importing jax, and its CUDA
sources are shipped and built for sm_90a."""

import os
import re
import subprocess
import sys

import ckb_zkp_tpu_torch
from ckb_zkp_tpu_torch.ops import cuda_build

PKG_DIR = os.path.dirname(ckb_zkp_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)

_PROVE_WITHOUT_JAX = """
import sys
import ckb_zkp_tpu_torch
from ckb_zkp_tpu_torch import _reference as R
from ckb_zkp_tpu_torch.schemes import groth16
curve = R.get_curve("bn254")
shape = R.square_chain_shape(62, curve.fr.modulus)
params = groth16.generate_parameters_from_shape(shape, curve, 2, 3, 5, 7, 11)
assert params.domain_size == 64
proof = groth16.create_proof_from_shape(params, shape, 0, 0)
pvk = groth16.prepare_verifying_key(curve, params.vk)
assert groth16.verify_proof(curve, pvk, proof, shape.input_assignment[1:])
assert "jax" not in sys.modules, "the port imported jax"
assert "ckb_zkp_tpu" not in sys.modules, "the port imported the JAX package"
print("PROVED_WITHOUT_JAX")
"""


def test_m64_prove_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", _PROVE_WITHOUT_JAX], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PROVED_WITHOUT_JAX" in res.stdout


def test_no_port_module_imports_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import ckb_zkp_tpu\b|from ckb_zkp_tpu\b)", re.M)
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    if pat.search(f.read()):
                        offenders.append(os.path.relpath(path, REPO))
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        if pat.search(f.read()):
            offenders.append("chip_smoke.py")
    assert offenders == []


def test_cuda_sources_and_build_command():
    for name in cuda_build.SOURCES + cuda_build.HEADERS:
        assert os.path.isfile(os.path.join(cuda_build.CSRC_DIR, name)), name
    cmd = cuda_build.build_command("/dev/null")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and all(
        os.path.join(cuda_build.CSRC_DIR, s) in cmd for s in cuda_build.SOURCES)
    assert cuda_build.BUILD_DIR.startswith(PKG_DIR)
    assert set(cuda_build.COUNTS) == {
        "mont_mul", "scan_prefix_madd", "scan_prefix_add", "scan_total_add", "rcb_add"}
