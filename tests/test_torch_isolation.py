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
              "planner.batch", "planner.cli", "plan", "dist.mesh_solve",
              "models.moe", "serving.router", "serving.router.router",
              "serving.router.prefix", "serving.router.spec", "capture",
              "capture.trace", "capture.program", "capture.plan",
              "capture.reference", "obs.fidelity", "obs.calibrate",
              "sharding", "sharding.rules", "launch.mesh", "dist.serve",
              "dist.serve_smoke", "models.parallel", "data", "data.pipeline",
              "checkpoint", "checkpoint.ckpt", "training",
              "training.optimizer", "training.train_step", "training.loop",
              "training.grad_compression", "launch.train",
              "core.mappers", "core.codesign", "core.sim_oracle",
              "launch.hlo_analysis", "launch.roofline", "launch.dryrun"):
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
    scanned = set()
    for p in PKG.rglob("*"):
        if p.is_file() and p.suffix in (".py", ".cu", ".cuh"):
            assert not pat.search(p.read_text()), p
            scanned.add(p.relative_to(PKG).as_posix())
    assert {"models/moe.py", "serving/router/__init__.py",
            "serving/router/router.py", "serving/router/prefix.py",
            "serving/router/spec.py", "capture/__init__.py",
            "capture/trace.py", "capture/program.py", "capture/plan.py",
            "capture/reference.py", "obs/fidelity.py",
            "obs/calibrate.py", "sharding/rules.py", "launch/mesh.py",
            "dist/serve.py", "dist/serve_smoke.py",
            "models/parallel.py", "data/pipeline.py", "checkpoint/ckpt.py",
            "training/optimizer.py", "training/train_step.py",
            "training/loop.py", "training/grad_compression.py",
            "launch/train.py"} <= scanned


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


def test_moe_continuous_serve_on_cpu_when_asked():
    res = _run("", "-m", "repro_torch.launch.serve", "--arch",
               "deepseek-moe-16b", "--smoke", "--continuous", "--requests",
               "3", "--prompt-len", "12", "--new-tokens", "3", "--device",
               "cpu")
    assert res.returncode == 0, res.stderr
    assert "deepseek-moe-16b-smoke continuous on cpu: 3 requests, 9 " \
        "tokens" in res.stdout


def test_scaleout_serve_on_cpu_when_asked(tmp_path):
    """Two replicas, a prefix cache, the n-gram drafter at width 4 and a
    plan store: the fleet serves every request, and a second run on the
    store, prewarmed once by its donor, puts nothing and makes no solver
    call; without --device cpu and without a card the same command exits
    non-zero."""
    args = ["-m", "repro_torch.launch.serve", "--arch", "llama3-8b",
            "--smoke", "--continuous", "--fused-mlp", "--replicas", "2",
            "--prefix-cache", "16", "--draft-model", "ngram",
            "--spec-width", "4", "--requests", "6", "--prompt-len", "40",
            "--new-tokens", "4", "--plan-db", str(tmp_path),
            "--prewarm-source", "enumerated"]
    for _ in range(2):
        res = _run("", *args, "--device", "cpu")
        assert res.returncode == 0, res.stderr
        assert "llama3-8b-smoke router x2 on cpu: 6 requests, 24 tokens" \
            in res.stdout
        assert "sched.spec.rounds" in res.stdout
    assert res.stdout.count("'puts': 0") == 2
    assert "solver calls: 0" in res.stdout
    res = _run("", *args)
    assert res.returncode != 0 and "--device cpu" in res.stderr


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
                                     "pareto", "solver", "fusion",
                                     "sim_oracle", "codesign")),
          *(f"core/mappers/{m}.py" for m in ("__init__", "base",
                                             "cosa_like", "factorflow",
                                             "goma", "loma",
                                             "random_search", "salsa")),
          "core/dist_mapping.py", "core/workloads.py",
          "dist/__init__.py", "dist/mesh_solve.py",
          "planner/manifest.py", "planner/store.py",
          "obs/calibrate.py",
          "capture/program.py",
          "serving/router/__init__.py", "serving/router/router.py",
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
