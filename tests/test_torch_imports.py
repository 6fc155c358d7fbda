"""The port imports neither JAX nor the JAX package.

Importing every ``repro_torch`` module, in a fresh interpreter, must leave
``jax`` and ``repro`` out of ``sys.modules``; and no import statement in
the package or in ``chip_smoke.py`` may name them.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"modules": names,
                  "leaked": sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "repro"))}))
"""


def test_importing_every_module_leaves_jax_and_repro_out():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    expected = {"repro_torch.kernels.ops", "repro_torch.launch.serve",
                "repro_torch.models.transformer", "repro_torch.convert",
                "repro_torch.core.scheduler", "repro_torch.targets",
                "repro_torch.tree", "repro_torch.data.pipeline",
                "repro_torch.optim.adamw", "repro_torch.optim.compression",
                "repro_torch.runtime.trainstep",
                "repro_torch.runtime.fault_tolerance",
                "repro_torch.checkpoint.store", "repro_torch.launch.train",
                "repro_torch.kernels.ssd_scan", "repro_torch.models.ssm",
                "repro_torch.models.mamba", "repro_torch.models.zamba",
                "repro_torch.models.moe", "repro_torch.models.whisper",
                "repro_torch.models.paligemma",
                "repro_torch.configs.whisper_base",
                "repro_torch.configs.paligemma_3b",
                "repro_torch.launch.attn_probes",
                "repro_torch.launch.ssd_probes", "repro_torch.sweep",
                "repro_torch.configs", "repro_torch.runtime.sharding",
                "repro_torch.runtime.collectives", "repro_torch.launch.mesh",
                "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                "repro_torch.roofline", "repro_torch.roofline.model",
                "repro_torch.roofline.collect"} | {
        f"repro_torch.core.{m}" for m in (
            "driver", "pipeline", "passes", "codegen", "cost", "stream",
            "interp", "semantics", "covenant", "search", "store",
            "targets", "sweep", "h100")} | {
        f"repro_torch.examples.{m}" for m in (
            "quickstart", "compile_layers", "new_accelerator",
            "sweep_variants", "warm_start_search", "serve_lm", "train_lm")}
    assert expected <= set(res["modules"])


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_names_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        assert not _imported_roots(f) & {"jax", "jaxlib", "repro"}, f
