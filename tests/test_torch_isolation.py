"""The port stands alone: it imports neither jax nor the reference
package, and its entry points refuse to fall back to the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def _run(code: str, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, *(["-c", code] if code else []), *args],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300)


def test_modules_found():
    assert "repro_torch.kernels.ops" in MODULES
    assert "repro_torch.launch.serve" in MODULES
    for m in ("kernels.wkv6", "kernels.mamba2_ssd", "models.rwkv",
              "models.ssm", "serving.sched.scheduler", "planner.store",
              "planner.batch", "planner.cli", "plan", "dist.mesh_solve"):
        assert f"repro_torch.{m}" in MODULES
    assert len(MODULES) >= 30


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr + res.stdout


def test_no_source_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import jax|from jax\b|import repro\b(?!_)|"
                     r"from repro\.|from repro\s+import)", re.M)
    for p in PKG.rglob("*"):
        if p.is_file() and p.suffix in (".py", ".cu", ".cuh"):
            assert not pat.search(p.read_text()), p


def test_serve_without_a_card_exits_nonzero():
    res = _run("", "-m", "repro_torch.launch.serve", "--arch", "llama3-8b",
               "--smoke", "--fused-mlp", "--new-tokens", "2")
    assert res.returncode != 0
    assert "--device cpu" in res.stderr


def test_recurrent_serve_without_a_card_exits_nonzero():
    res = _run("", "-m", "repro_torch.launch.serve", "--arch", "rwkv6-7b",
               "--smoke", "--scan-kernel", "--new-tokens", "2")
    assert res.returncode != 0
    assert "--device cpu" in res.stderr


@pytest.mark.parametrize("arch,flags", [
    ("rwkv6-7b", ["--scan-kernel"]),
    ("zamba2-2.7b", ["--scan-kernel", "--fused-mlp"])])
def test_recurrent_serve_on_cpu_when_asked(arch, flags):
    res = _run("", "-m", "repro_torch.launch.serve", "--arch", arch,
               "--smoke", *flags, "--batch", "2", "--prompt-len", "12",
               "--new-tokens", "3", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert f"{arch}-smoke on cpu" in res.stdout


def test_serve_on_cpu_when_asked():
    res = _run("", "-m", "repro_torch.launch.serve", "--arch", "llama3-8b",
               "--smoke", "--fused-mlp", "--batch", "2", "--prompt-len", "8",
               "--new-tokens", "3", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert "llama3-8b-smoke on cpu" in res.stdout


def test_continuous_serve_without_a_card_exits_nonzero():
    res = _run("", "-m", "repro_torch.launch.serve", "--arch", "llama3-8b",
               "--smoke", "--continuous", "--fused-mlp", "--requests", "2")
    assert res.returncode != 0
    assert "--device cpu" in res.stderr


def test_continuous_serve_on_cpu_when_asked():
    res = _run("", "-m", "repro_torch.launch.serve", "--arch", "llama3-8b",
               "--smoke", "--continuous", "--fused-mlp", "--requests", "4",
               "--prompt-len", "12", "--new-tokens", "3", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert "llama3-8b-smoke continuous on cpu: 4 requests, 12 tokens" \
        in res.stdout
    assert "ttft p50/p95" in res.stdout


def test_init_params_on_a_missing_card_raises():
    code = ("import torch\n"
            "from repro_torch.configs import get_config\n"
            "from repro_torch.models import build_model\n"
            "m = build_model(get_config('llama3-8b', smoke=True))\n"
            "try:\n"
            "    m.init_params(torch.Generator(), 'cuda')\n"
            "except (RuntimeError, AssertionError) as e:\n"
            "    print('raised', type(e).__name__)\n")
    res = _run(code)
    assert res.returncode == 0 and "raised" in res.stdout, res.stderr


COPIED = ["faults.py", "configs/__init__.py", "configs/base.py",
          *(f"configs/{p.name}" for p in (ROOT / "src" / "repro"
                                          / "configs").glob("*_*.py")),
          *(f"core/{m}.py" for m in ("geometry", "hardware", "energy",
                                     "certificate", "edp", "timeloop_ref",
                                     "pareto", "solver", "fusion")),
          "core/dist_mapping.py", "core/workloads.py",
          "dist/__init__.py", "dist/mesh_solve.py",
          "planner/manifest.py", "planner/store.py",
          "obs/registry.py", "obs/tracing.py",
          *(f"serving/sched/{m}.py" for m in ("__init__", "requests",
                                              "buckets", "slots", "metrics",
                                              "traffic"))]


def test_copies_differ_from_the_reference_only_in_imports():
    """The jax-free planning stack is a verbatim copy: line for line equal
    to the reference's, apart from lines that import."""
    for rel in COPIED:
        ref = (ROOT / "src" / "repro" / rel).read_text().splitlines()
        port = (PKG / rel).read_text().splitlines()
        assert len(ref) == len(port), rel
        for a, b in zip(ref, port):
            assert a == b or ("import" in a and "import" in b), (rel, a, b)
