"""The port's examples (``repro_torch.examples``) stay runnable, as
``tests/test_examples.py`` holds the reference's: each runs as ``python -m
repro_torch.examples.<name>`` and prints the reference script's markers.
``serve_lm`` and ``train_lm`` run on ``--device cpu`` here; the loss
falling over 30 steps is gated on the card (``chip_smoke.py`` phase 15).
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, timeout=600, extra=(), script=False):
    env = dict(os.environ, PYTHONPATH="src")
    cmd = [module] if script else ["-m", f"repro_torch.examples.{module}"]
    return subprocess.run([sys.executable, *cmd, *extra],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=timeout)


def test_quickstart_runs_with_the_reference_cycles():
    r = _run("quickstart")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "correct=True" in r.stdout
    assert "=== hvx ===" in r.stdout and "=== dnnweaver ===" in r.stdout
    ref = _run("examples/quickstart.py", script=True)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert r.stdout == ref.stdout


def test_new_accelerator_runs():
    r = _run("new_accelerator")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "registered 'edge_npu'" in r.stdout
    assert "derived 'edge_npu@pe=8x8'" in r.stdout


def test_serve_lm_runs_on_cpu():
    r = _run("serve_lm", extra=("--device", "cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "block total" in r.stdout
    assert "[serve] gemma3-12b on cpu" in r.stdout


def test_train_lm_runs_on_cpu(tmp_path):
    r = _run("train_lm", extra=("--device", "cpu", "--steps", "3",
                                "--ckpt-dir", str(tmp_path)))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "loss" in r.stdout


def test_train_lm_param_count_matches_reference():
    """The example prints ``roofline.param_count(cfg)``, as the
    reference's prints its own ``roofline.param_count``: the two agree on
    the example's config."""
    from repro import configs as ref_configs
    from repro.roofline import param_count as ref_param_count
    from repro_torch.examples import train_lm
    from repro_torch.roofline import param_count

    cfg = train_lm.config()
    ref = ref_configs.get_config("qwen3-0.6b").replace(
        n_layers=10, d_model=768, n_heads=12, n_kv_heads=6, d_ff=3072,
        vocab=32768, head_dim=64, param_dtype="float32",
        compute_dtype="float32", remat=False)
    assert param_count(cfg) == ref_param_count(ref)


@pytest.mark.slow
def test_compile_layers_sweep():
    r = _run("compile_layers", timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BERT-LG-GEMM1" in r.stdout


@pytest.mark.slow
def test_sweep_variants_example(tmp_path):
    r = _run("sweep_variants", timeout=1200,
             extra=("--workers", "2", "--store", str(tmp_path / "store")))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "each compiled exactly once" in r.stdout
    warm = [x for x in r.stdout.splitlines() if x.startswith("[warm]")]
    assert warm and ", 0 pipeline stages run" in warm[0]


@pytest.mark.search
def test_warm_start_search_example(tmp_path):
    r = _run("warm_start_search", timeout=1200,
             extra=("--store", str(tmp_path / "store")))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "winners pinned" in r.stdout
    assert "seed(s) injected" in r.stdout
    assert "warm-start index:" in r.stdout
