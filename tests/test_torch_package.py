"""The port stands alone: it sets up, proves and verifies without ever
importing jax or loading a file of the JAX package, its entry points run on
the card unless asked for the CPU, and its CUDA sources are shipped and
built for sm_90a."""

import inspect
import os
import re
import subprocess
import sys

import pytest

import ckb_zkp_tpu_torch
from ckb_zkp_tpu_torch import contracts, convert
from ckb_zkp_tpu_torch.cli.main import (_read_artifact, _srs_from_portable, _srs_to_portable,
                                        prove_cmd, setup_cmd, struct_decode, verify_cmd)
from ckb_zkp_tpu_torch.curve import Curve
from ckb_zkp_tpu_torch.ops import (cuda_build, cuda_probe, field, limbs, msm, ntt,
                                   ristretto_device, sumcheck)
from ckb_zkp_tpu_torch.probes import common, dma, grid, mxu, scan, window
from ckb_zkp_tpu_torch.ops.hdomain import HDomain
from ckb_zkp_tpu_torch.parallel import mesh as par_mesh
from ckb_zkp_tpu_torch.parallel import multihost, ntt as par_ntt
from ckb_zkp_tpu_torch.schemes import asvc, kzg10, marlin
from ckb_zkp_tpu_torch.schemes.groth16 import generator, qap, serialize
from ckb_zkp_tpu_torch.schemes.marlin import ahp
from ckb_zkp_tpu_torch.schemes.plonk import Plonk
from ckb_zkp_tpu_torch.schemes.plonk.plonk import VerifierKey as PlonkVerifierKey
from ckb_zkp_tpu_torch.schemes.spartan import common as sp_common
from ckb_zkp_tpu_torch.schemes.spartan import nizk, snark
from ckb_zkp_tpu_torch.schemes.bulletproofs import arithmetic_circuit as bp_ac
from ckb_zkp_tpu_torch.schemes.bulletproofs import inner_product_proof as bp_ipp
from ckb_zkp_tpu_torch.schemes.hyrax import hyrax_proof, zk_sumcheck
from ckb_zkp_tpu_torch.schemes.hyrax import params as hy_params
from ckb_zkp_tpu_torch.schemes.libra import linear_gkr, zk_linear_gkr
from ckb_zkp_tpu_torch.serialize import ark_schemes

PKG_DIR = os.path.dirname(ckb_zkp_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
JAX_PKG_DIR = os.path.join(REPO, "ckb_zkp_tpu")

_PROVE_WITHOUT_JAX = """
import os, sys
import ckb_zkp_tpu_torch
from ckb_zkp_tpu_torch.bench_circuits import square_chain_shape
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.schemes import groth16
from ckb_zkp_tpu_torch.schemes.groth16 import serialize
from ckb_zkp_tpu_torch.circuits import Mini
import ckb_zkp_tpu_torch.schemes.marlin, ckb_zkp_tpu_torch.schemes.kzg10
import ckb_zkp_tpu_torch.ops.poly, ckb_zkp_tpu_torch.ops.hdomain, ckb_zkp_tpu_torch.transcript
import ckb_zkp_tpu_torch.schemes.plonk, ckb_zkp_tpu_torch.schemes.plonk.serialize
import ckb_zkp_tpu_torch.schemes.asvc, ckb_zkp_tpu_torch.contracts
import ckb_zkp_tpu_torch.serialize.ark_schemes, ckb_zkp_tpu_torch.convert
import ckb_zkp_tpu_torch.schemes.spartan, ckb_zkp_tpu_torch.host.ristretto
import ckb_zkp_tpu_torch.ops.ristretto_device, ckb_zkp_tpu_torch.ops.sumcheck
import ckb_zkp_tpu_torch.ops.edwards
import ckb_zkp_tpu_torch.schemes.bulletproofs, ckb_zkp_tpu_torch.schemes.hyrax
import ckb_zkp_tpu_torch.schemes.libra
import ckb_zkp_tpu_torch.gadgets, ckb_zkp_tpu_torch.circuits, ckb_zkp_tpu_torch.curve
import ckb_zkp_tpu_torch.host.edwards_groups, ckb_zkp_tpu_torch.serialize.struct_codec
import ckb_zkp_tpu_torch.native, ckb_zkp_tpu_torch.cli, ckb_zkp_tpu_torch.cli.main
import ckb_zkp_tpu_torch.parallel
curve = get_curve("bn254")
shape = square_chain_shape(62, curve.fr.modulus)
params = groth16.generate_parameters_from_shape(
    shape, curve, 2, 3, 5, 7, 11, device="cpu")
assert params.domain_size == 64
proof = groth16.create_proof_from_shape(params, shape, 0, 0)
pvk = groth16.prepare_verifying_key(curve, params.vk)
assert groth16.verify_proof(curve, pvk, proof, shape.input_assignment[1:])
from ckb_zkp_tpu_torch.serialize import struct_codec
name = b"ckb_zkp_tpu.schemes.groth16.types:Proof"  # a JAX package class, no stand-in
try:
    struct_codec.decode(curve, b"D" + bytes([len(name)]) + name + b"N" * 3)
    raise SystemExit("decoded a class that no stand-in registers")
except struct_codec.DecodeError:
    pass
assert "jax" not in sys.modules, "the port imported jax"
assert "ckb_zkp_tpu" not in sys.modules, "the port imported the JAX package"
jax_dir = os.path.realpath(sys.argv[1]) + os.sep
loaded = [name for name, mod in list(sys.modules.items())
          if os.path.realpath(getattr(mod, "__file__", None) or "").startswith(jax_dir)]
assert not loaded, f"files of the JAX package were loaded: {loaded}"
print("PROVED_WITHOUT_JAX")
"""


_PROBES_WITHOUT_JAX = """
import os, sys
import ckb_zkp_tpu_torch.probes.mxu
import ckb_zkp_tpu_torch.probes.scan
import ckb_zkp_tpu_torch.probes.window
import ckb_zkp_tpu_torch.probes.grid
import ckb_zkp_tpu_torch.probes.dma
import ckb_zkp_tpu_torch.probes.levels
import ckb_zkp_tpu_torch.ops.mont_tc
assert "jax" not in sys.modules, "a probe imported jax"
jax_dir = os.path.realpath(sys.argv[1]) + os.sep
loaded = [name for name, mod in list(sys.modules.items())
          if os.path.realpath(getattr(mod, "__file__", None) or "").startswith(jax_dir)]
assert not loaded, f"files of the JAX package were loaded: {loaded}"
print("PROBES_WITHOUT_JAX")
"""


def _run_without_jax(script: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-c", script, JAX_PKG_DIR], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300,
    )


def test_probes_import_without_jax():
    res = _run_without_jax(_PROBES_WITHOUT_JAX)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PROBES_WITHOUT_JAX" in res.stdout


def test_m64_prove_runs_without_jax():
    res = _run_without_jax(_PROVE_WITHOUT_JAX)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PROVED_WITHOUT_JAX" in res.stdout


_IMPORTS_JAX = re.compile(
    r"^\s*(import jax|from jax|import ckb_zkp_tpu\b|from ckb_zkp_tpu\b)", re.M)
# a loader that reaches the JAX package's files without importing it
_LOADS_JAX_FILES = re.compile(
    r"find_spec\(\s*[\"']ckb_zkp_tpu[\"']|submodule_search_locations|"
    r"__path__\s*=|spec_from_file_location|\b_reference\b")


def _port_sources():
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_port_module_imports_jax():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            src = f.read()
        if _IMPORTS_JAX.search(src) or _LOADS_JAX_FILES.search(src):
            offenders.append(os.path.relpath(path, REPO))
    assert offenders == []
    assert not os.path.exists(os.path.join(PKG_DIR, "_reference.py"))


def test_source_scan_rejects_the_alias_loader():
    for src in ('spec = importlib.util.find_spec("ckb_zkp_tpu")',
                "mod.__path__ = [root]",
                "from ckb_zkp_tpu_torch._reference import get_curve"):
        assert _LOADS_JAX_FILES.search(src), src
    assert not _LOADS_JAX_FILES.search("from .host.pairing import get_curve")


@pytest.mark.parametrize("fn,arg", [
    (field.DeviceField.__init__, "device"), (field.device_field, "device"),
    (ntt.get_domain, "device"), (msm.DeviceCurveGroup.__init__, "device"),
    (msm.device_group, "device"), (limbs.to_torch, "device"),
    (convert.params_from_reference, "device"), (qap.qap_matrices, "device"),
    (qap.QapMatrices.__init__, "device"),
    (generator.generate_parameters_from_shape, "device"),
    (generator.generate_random_parameters, "device"), (generator.generate_parameters, "device"),
    (serialize.parameters_from_bytes, "device"),
    (common.rand_field, "device"), (window.check, "device"), (window.measure, "device"),
    (window.make_inputs, "device"), (scan.check, "device"), (scan.measure, "device"),
    (scan.make_inputs, "device"), (mxu.check, "device"), (mxu.measure, "device"),
    (mxu.make_inputs, "device"), (cuda_probe.band_mma_matrix, "device"),
    (grid.check, "device"), (grid.measure, "device"), (dma.check, "device"),
    (dma.measure, "device"), (dma.make_inputs, "device"), (dma.rand_words, "device"),
    (HDomain.__init__, "device"), (kzg10.setup, "device"), (marlin.universal_setup, "device"),
    (ahp.index, "device"), (ahp.verifier_first_round, "device"),
    (convert.srs_from_reference, "device"), (Plonk.setup, "device"), (Plonk.index, "device"),
    (PlonkVerifierKey, "device"), (asvc.key_gen, "device"),
    (convert.asvc_params_from_reference, "device"),
    (contracts.universal_marlin_verifier, "device"),
    (contracts.universal_plonk_verifier, "device"),
    (ark_schemes.ArkSchemeCodec.__init__, "device"), (ark_schemes.ark_decode, "device"),
    (msm.msm_over_fixed_base, "device"), (msm.msm_over_fixed_base_many, "device"),
    (ristretto_device.DeviceRistrettoGroup.__init__, "device"),
    (ristretto_device.device_ristretto_group, "device"),
    (sumcheck.DeviceSumcheck.__init__, "device"), (sp_common.poly_commit_vec, "device"),
    (sp_common.packing_poly_commit, "device"), (nizk.create_nizk_proof, "device"),
    (nizk.verify_nizk_proof, "device"), (snark.generate_random_parameters, "device"),
    (snark.create_snark_proof, "device"), (snark.verify_snark_proof, "device"),
    (contracts.universal_spartan_nizk_verifier, "device"),
    (contracts.universal_spartan_snark_verifier, "device"),
    (msm.generator_multiples, "device"), (sp_common.poly_commitment_parameters, "device"),
    (sp_common.r1cs_satisfied_parameters, "device"), (nizk.generate_setup_parameters, "device"),
    (snark.generate_setup_snark_parameters, "device"),
    (bp_ac.create_random_proof, "device"), (bp_ac.prove, "device"), (bp_ipp.prove, "device"),
    (contracts.mini_bulletproofs_verifier, "device"), (hy_params.Parameters.new, "device"),
    (hy_params.EqProof.prover, "device"), (hy_params.EqProof.verify, "device"),
    (hy_params.ProductProof.prover, "device"), (hy_params.ProductProof.verify, "device"),
    (hy_params.LogDotProductProof.reduce_prover, "device"),
    (hy_params.LogDotProductProof.reduce_verifier, "device"),
    (zk_sumcheck.ZkSumcheckProof.prover, "device"), (zk_sumcheck.ZkSumcheckProof.verify, "device"),
    (hyrax_proof.HyraxProof.prover, "device"), (hyrax_proof.HyraxProof.verify, "device"),
    (linear_gkr.DeviceLayer.__init__, "device"), (linear_gkr.LinearGKRProof.prover, "device"),
    (linear_gkr.LinearGKRProof.verify, "device"), (zk_linear_gkr.Parameters.new, "device"),
    (zk_linear_gkr.ZKLinearGKRProof.prover, "device"),
    (zk_linear_gkr.ZKLinearGKRProof.verify, "device"),
    (contracts.mini_libra_zk_linear_gkr_verifier, "device"),
    (contracts.mini_hyrax_zk_linear_gkr_verifier, "device"),
    (setup_cmd, "device"), (prove_cmd, "device"), (verify_cmd, "device"),
    (struct_decode, "device"), (_read_artifact, "device"), (_srs_to_portable, "device"),
    (_srs_from_portable, "device"),
    (Curve.device, "device"), (Curve.vartime_multiscalar_mul, "device"),
    (par_mesh.make_mesh, "device"), (par_mesh.rank_device, "device"),
    (multihost.init_multihost, "device"), (multihost.global_mesh, "device"),
    (par_ntt.ShardedDomain.__init__, "device"),
])
def test_entry_points_default_to_the_card(fn, arg):
    assert inspect.signature(fn).parameters[arg].default == "cuda"


def test_cuda_sources_and_build_command():
    for name in cuda_build.SOURCES + cuda_build.HEADERS:
        assert os.path.isfile(os.path.join(cuda_build.CSRC_DIR, name)), name
    for src in cuda_build.SOURCES:
        cmd = cuda_build.compile_command(src, "/dev/null")
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
        assert os.path.join(cuda_build.CSRC_DIR, src) in cmd
    link = cuda_build.link_command(["a.o", "b.o"], "/dev/null")
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in link
    assert cuda_build.BUILD_DIR.startswith(PKG_DIR)
    assert set(cuda_build.COUNTS) == {
        "mont_mul", "scan_prefix_madd", "scan_prefix_add", "scan_total_add",
        "rcb_add", "rcb_madd", "rcb_fixed_base", "ec_add", "ec_add_chain", "ec_madd",
        "ec_fixed_base", "ec_block_totals_madd",
        "ec_block_totals_add", "scan_prefix_madd_unpacked", "scan_prefix_madd_packed",
        "probe_madd_totals", "probe_madd_prefix_packed", "probe_chain_mul",
        "probe_gmajor_totals", "probe_gmajor_prefix", "probe_u32_ops", "probe_band_mma",
        "probe_mul_chain_cios", "probe_mul_chain_tc", "probe_gmajor_totals_tc",
        "probe_madd_totals_tc", "probe_grid_totals", "probe_grid_prefix", "probe_wo_steps",
        "probe_wo_tile", "probe_grid_prefix_tile", "probe_xor_flat", "probe_xor_lead1",
        "probe_xor_grid2d"}
    # the 12-word instances of K1-K6, counted beside their names
    assert set(cuda_build.WIDE) == {"mont_mul", "scan_prefix_madd", "scan_prefix_add",
                                    "scan_total_add", "rcb_add", "rcb_fixed_base"}
    # of those, the launches of the twelve-word designs (rcb_wide.cuh), a kernel each
    assert set(cuda_build.WIDE_DESIGN) == {"scan_prefix_madd_g2", "rcb_fixed_base_g1",
                                           "rcb_fixed_base_g2"}
