"""Importing the torch port must pull in no JAX, no Triton and no part
of the JAX package, and must build nothing: the package imports on
machines with no GPU and no CUDA toolkit."""

import json
import os
import subprocess
import sys

import pytest

_PROBE = r"""
import json, os, pkgutil, sys
import pytorch_hmm_tpu_torch as pkg
from pytorch_hmm_tpu_torch.ops import _build

build_dir = str(_build.BUILD_DIR)
before = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else None
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    __import__(name)
after = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else None
banned = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "triton", "pytorch_hmm_tpu")]
print(json.dumps({"modules": names, "banned": banned, "same_build": before == after}))
"""


def test_port_imports_no_jax_no_triton_and_builds_nothing():
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, timeout=300, env=env, cwd=repo_root)
    assert r.returncode == 0, r.stdout + r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["banned"] == []
    assert got["same_build"]
    expected = {
        "pytorch_hmm_tpu_torch.alignment.ctc",
        "pytorch_hmm_tpu_torch.alignment.ctc_decode",
        "pytorch_hmm_tpu_torch.alignment.dtw",
        "pytorch_hmm_tpu_torch.bridge",
        "pytorch_hmm_tpu_torch.core.fb",
        "pytorch_hmm_tpu_torch.core.hsmm",
        "pytorch_hmm_tpu_torch.core.sample",
        "pytorch_hmm_tpu_torch.core.semiring",
        "pytorch_hmm_tpu_torch.core.viterbi",
        "pytorch_hmm_tpu_torch.durations",
        "pytorch_hmm_tpu_torch.emissions",
        "pytorch_hmm_tpu_torch.frontend",
        "pytorch_hmm_tpu_torch.hmm",
        "pytorch_hmm_tpu_torch.models.hmm_layer",
        "pytorch_hmm_tpu_torch.models.hsmm",
        "pytorch_hmm_tpu_torch.models.mixture_gaussian",
        "pytorch_hmm_tpu_torch.models.neural",
        "pytorch_hmm_tpu_torch.models.semi_markov",
        "pytorch_hmm_tpu_torch.ops._build",
        "pytorch_hmm_tpu_torch.ops.bigk",
        "pytorch_hmm_tpu_torch.ops.ctc_kernel",
        "pytorch_hmm_tpu_torch.ops.dtw",
        "pytorch_hmm_tpu_torch.ops.emit",
        "pytorch_hmm_tpu_torch.ops.emit_mlp",
        "pytorch_hmm_tpu_torch.ops.fbsum",
        "pytorch_hmm_tpu_torch.ops.fused",
        "pytorch_hmm_tpu_torch.ops.hsmm_smallk",
        "pytorch_hmm_tpu_torch.ops.scan",
        "pytorch_hmm_tpu_torch.ops.smallk",
        "pytorch_hmm_tpu_torch.ops.stream",
        "pytorch_hmm_tpu_torch.ops.stream_multi",
        "pytorch_hmm_tpu_torch.precision",
        "pytorch_hmm_tpu_torch.streaming",
        "pytorch_hmm_tpu_torch.trace",
        "pytorch_hmm_tpu_torch.utils",
    }
    assert expected <= set(got["modules"])


def test_port_exports_the_prob_chains_and_full_covariance_under_the_reference_names():
    """The names the JAX package exports for rows 10-12 and for full
    covariance, importable from the port without JAX."""
    probe = (
        "import sys\n"
        "from pytorch_hmm_tpu_torch import ops, emissions\n"
        "from pytorch_hmm_tpu_torch.ops import (pallas_backward_prob, pallas_fb_prob,\n"
        "    pallas_forward_prob, prob_supported)\n"
        "from pytorch_hmm_tpu_torch.emissions import (flat_dim, full_gaussian_log_probs,\n"
        "    full_gaussian_log_probs_prepared, fullcov_mixture_log_probs_prepared,\n"
        "    fullcov_prepare, tril_from_flat, tril_inverse)\n"
        "import pytorch_hmm_tpu_torch as pkg\n"
        "assert pkg.full_gaussian_log_probs is full_gaussian_log_probs\n"
        "assert {'pallas_forward_prob', 'pallas_backward_prob', 'pallas_fb_prob'} <= set(ops.__all__)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'pytorch_hmm_tpu')]\n"
    )
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                       timeout=300, env=env, cwd=repo_root)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_exports_ctc_under_the_reference_names():
    """The JAX package's CTC names (``alignment``, its package-level
    exports, the lattice kernels' wrappers), importable from the port
    without JAX."""
    probe = (
        "import sys\n"
        "from pytorch_hmm_tpu_torch.alignment import (CTCAligner, CTCSegmentationAligner,\n"
        "    beam_search_decode_batch, collapse_repeated_tokens, ctc_alignment_path,\n"
        "    ctc_backward_algorithm, ctc_decode_sequence, ctc_forward_algorithm, ctc_loss,\n"
        "    ctc_viterbi_alignment, expand_targets_with_blank, greedy_decode_batch,\n"
        "    remove_ctc_blanks)\n"
        "from pytorch_hmm_tpu_torch.ops import (ctc_lattice_backward, ctc_lattice_forward,\n"
        "    ctc_lattice_supported, ctc_lattice_viterbi, ctc_lattice_viterbi_wide,\n"
        "    ctc_viterbi_kernel_supported, ctc_viterbi_wide_supported)\n"
        "import pytorch_hmm_tpu_torch as pkg\n"
        "assert pkg.CTCAligner is CTCAligner and pkg.ctc_alignment_path is ctc_alignment_path\n"
        "assert {'CTCAligner', 'CTCSegmentationAligner', 'ctc_alignment_path', 'alignment'} <= set(pkg.__all__)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'pytorch_hmm_tpu')]\n"
    )
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                       timeout=300, env=env, cwd=repo_root)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_exports_dtw_and_large_state_scoring_under_the_reference_names():
    """The JAX package's DTW names (``alignment``, its package-level
    exports) and the two ops' wrappers, importable from the port without
    JAX and without building a kernel."""
    probe = (
        "import sys\n"
        "from pytorch_hmm_tpu_torch.alignment import (ConstrainedDTWAligner, DTWAligner,\n"
        "    compute_distance_matrix, compute_dtw_path, dtw_alignment, dtw_distance,\n"
        "    extract_phoneme_durations, phoneme_audio_alignment, soft_dtw, soft_dtw_alignment)\n"
        "from pytorch_hmm_tpu_torch.alignment.dtw import dtw_path_padded\n"
        "from pytorch_hmm_tpu_torch.ops import (bigk_log_likelihood, bigk_log_likelihood_reference,\n"
        "    bigk_supported, pallas_dtw, pallas_dtw_reference, pallas_dtw_supported)\n"
        "import pytorch_hmm_tpu_torch as pkg\n"
        "assert pkg.DTWAligner is DTWAligner and pkg.dtw_alignment is dtw_alignment\n"
        "assert pkg.ConstrainedDTWAligner is ConstrainedDTWAligner\n"
        "assert {'DTWAligner', 'ConstrainedDTWAligner', 'dtw_alignment'} <= set(pkg.__all__)\n"
        "assert pallas_dtw.launches == 0 and bigk_log_likelihood.launches == 0\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'triton', 'pytorch_hmm_tpu')]\n"
        "from pytorch_hmm_tpu_torch.ops import _build\n"
        "assert not _build._loaded\n"
    )
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                       timeout=300, env=env, cwd=repo_root)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_never_names_jax_in_its_sources():
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(repo_root, "pytorch_hmm_tpu_torch")
    offenders, seen = [], set()
    for dirpath, _dirs, files in os.walk(pkg):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            seen.add(os.path.relpath(path, pkg))
            with open(path) as f:
                for lineno, line in enumerate(f, 1):
                    words = line.split()
                    if words[:1] in (["import"], ["from"]) and any(
                        w.split(".")[0] in ("jax", "flax", "orbax", "triton", "pytorch_hmm_tpu")
                        for w in words[1:2]
                    ):
                        offenders.append(f"{path}:{lineno}: {line.strip()}")
    assert not offenders, "\n".join(offenders)
    # The scan reaches every kernel source's wrapper module.
    wrappers = {"diag_quadratic": "emit.py", "emit_mlp": "emit_mlp.py", "smallk_viterbi": "smallk.py",
                "smallk_sum": "hsmm_smallk.py", "hsmm_smallk": "hsmm_smallk.py",
                "hsmm_grads": "hsmm_smallk.py",
                "stream_greedy": "stream.py", "stream_beam": "stream_multi.py",
                "scan_bigk": "scan.py", "scan_prob": "scan.py", "fused_gmm": "fused.py",
                "ctc_lattice": "ctc_kernel.py", "dtw": "dtw.py", "bigk_scoring": "bigk.py"}
    sources = {fn[:-3] for fn in os.listdir(os.path.join(pkg, "csrc")) if fn.endswith(".cu")}
    assert sources == set(wrappers)
    assert {os.path.join("ops", w) for w in wrappers.values()} <= seen


def test_only_the_build_seam_marshals_the_kernel_abi():
    """Every kernel launch goes through ``ops/_build.py``: no other source
    of the port takes a tensor's address or the current stream."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(repo_root, "pytorch_hmm_tpu_torch")
    seam = os.path.join(pkg, "ops", "_build.py")
    offenders, seen = [], 0
    for dirpath, _dirs, files in os.walk(pkg):
        for fn in files:
            path = os.path.join(dirpath, fn)
            if not fn.endswith(".py") or path == seam:
                continue
            seen += 1
            with open(path) as f:
                offenders += [f"{path}:{lineno}: {line.strip()}" for lineno, line in enumerate(f, 1)
                              if ".data_ptr()" in line or "current_stream(" in line]
    assert seen > 12
    assert not offenders, "\n".join(offenders)


@pytest.mark.parametrize("name", ["hsmm", "gmm_hmm", "tf32"])
def test_benchmark_references_import_neither_jax_nor_either_package(name):
    """The benchmark's plain references (``bench_torch/reference/``) are
    plain torch: importing one loads no JAX and no module of the JAX
    package or of the port, and its source imports none of them."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    probe = (
        "import sys\n"
        f"import bench_torch.reference.{name}\n"
        "banned = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'jaxlib', 'flax', 'triton', 'pytorch_hmm_tpu', 'pytorch_hmm_tpu_torch')]\n"
        "assert not banned, banned\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                       timeout=300, env=env, cwd=repo_root)
    assert r.returncode == 0, r.stdout + r.stderr
    path = os.path.join(repo_root, "bench_torch", "reference", f"{name}.py")
    with open(path) as f:
        imported = [line.split()[1].split(".")[0] for line in f
                    if line.split()[:1] in (["import"], ["from"])]
    assert not set(imported) & {"jax", "flax", "triton", "pytorch_hmm_tpu", "pytorch_hmm_tpu_torch"}
