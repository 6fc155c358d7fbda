"""What a run loads: no module whose top-level name, as a whole, is
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``; and the
reference loads nothing of the program."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from bench_smoke import ROOT

PROBE = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_levels(body: str) -> set:
    code = PROBE.format(src=os.path.join(ROOT, "src"), root=ROOT,
                        tests=os.path.dirname(os.path.abspath(__file__)),
                        body=body)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=env, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_each_kind_loads_no_jax():
    body = ("from bench_smoke import CELLS, run_line, smoke_cell\n"
            "for c in CELLS: run_line(smoke_cell(c))\n"
            "import bench.control, bench.trace")
    loaded = _top_levels(body)
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    body = ("import bench.reference.common, bench.reference.transformer, "
            "bench.reference.dense, bench.reference.moe, "
            "bench.reference.training, bench.compare, bench.yardstick")
    loaded = _top_levels(body)
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_are_whole_top_levels():
    from bench.run import forbidden_modules

    sys.modules["repro_torch_probe"] = sys.modules[__name__]
    sys.modules["repro.fake"] = sys.modules[__name__]
    try:
        found = forbidden_modules()
        assert "repro.fake" in found and "repro_torch_probe" not in found
    finally:
        del sys.modules["repro_torch_probe"], sys.modules["repro.fake"]


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench", "run.py"), "--workload",
         "olmoe-1b-7b.train-2x2048", "--seed", str(2 ** 31 + 3),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
