"""The port's Covenant compile driver (``repro_torch.core``) against the
reference's (``repro.core``) on the same inputs.

Every paper layer on every covenant (the reference's four bundled ones and
the port's ``h100``, which the reference reads back through
``ACGSpec.from_dict`` and never registers) compiles to the same analytic
cycles, exactly, under the same content-addressed key and with the same
schedule notes; small layers give the same mnemonic listings, bit-equal
stream-machine and interpreter outputs and pass ``verify``; broken pairs
raise the same violations; derived variants and seeded searches agree;
and the port's disk store (``REPRO_TORCH_CACHE_DIR``) replays in a fresh
process but never serves an entry the reference wrote.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro
from repro.core import interp as ref_interp
from repro.core import library as ref_library
from repro.core import scheduler as ref_scheduler
from repro.core import targets as ref_targets
from repro.core.acg import ACG as RefACG
from repro.core.spec import ACGSpec as RefACGSpec
from repro.core.spec import parse_overrides

import repro_torch
from repro_torch.core import interp, library, scheduler, targets
from repro_torch.targets import H100_SPEC

from conftest import random_inputs

ROOT = Path(__file__).resolve().parents[1]
TARGETS = ["example", "dnnweaver", "hvx", "tpu_v5e", "h100"]
LAYERS = [layer.key for layer in ref_library.PAPER_LAYERS]
# h100 with an HBM of 4096 lines (512 KB): the stream machine allocates
# every memory node whole, and the card's 80 GB do not fit the host
SMALL_H100 = "h100@HBM.depth=4096"


def ref_target(name: str):
    """The reference's handle on a target name of the port: its own name,
    or for ``h100`` (and variants of it) the port's spec read back as
    data."""
    base, _, overrides = name.partition("@")
    if base != "h100":
        return name
    spec = RefACGSpec.from_dict(H100_SPEC.to_dict())
    if overrides:
        spec = spec.derive(**parse_overrides(overrides))
    return spec


SMALL = {
    "gemm": lambda lib: lib.gemm(8, 16, 12),
    "gemm_bf16": lambda lib: lib.gemm(8, 16, 16, in_dtype="bf16",
                                      acc_dtype="f32"),
    "add": lambda lib: lib.elementwise("ADD", 64, "i32"),
    "add_f32": lambda lib: lib.elementwise("ADD", 256, "f32"),
    "conv": lambda lib: lib.conv2d(1, 6, 6, 4, 8, 3, 3, 1, name="conv_r"),
}
# the small layers each target's covenant admits, with a covenant small
# enough for the stream machine (see SMALL_H100)
RUNS = [("example", "gemm"), ("example", "conv"),
        ("dnnweaver", "gemm"), ("dnnweaver", "add"), ("dnnweaver", "conv"),
        ("hvx", "gemm"), ("hvx", "add"), ("hvx", "conv"),
        (SMALL_H100, "gemm"), (SMALL_H100, "gemm_bf16"), (SMALL_H100, "add"),
        (SMALL_H100, "add_f32"), (SMALL_H100, "conv")]
LISTINGS = [("example", "gemm"), ("dnnweaver", "add"), ("hvx", "conv"),
            ("tpu_v5e", "gemm_bf16"), ("h100", "gemm"),
            ("h100", "gemm_bf16"), ("h100", "add_f32")]


def _same_program(mine, ref):
    assert [m.encode() for m in mine.program.mnemonics] == \
        [m.encode() for m in ref.program.mnemonics]
    n = len(ref.program.mnemonics)
    assert mine.listing(n) == ref.listing(n)


@pytest.mark.parametrize("name", TARGETS)
def test_bundled_specs_match_reference(name):
    """The four copied specs hash to the reference's; ``h100`` to its
    reading through ``ACGSpec.from_dict``; both sides find every built
    graph sound."""
    ref = ref_target(name)
    if isinstance(ref, str):
        ref_spec, ref_acg = ref_targets.get_spec(ref), \
            ref_targets.get_target(ref)
    else:
        ref_spec, ref_acg = ref, RefACG.from_spec(ref)
    assert targets.get_spec(name).fingerprint() == ref_spec.fingerprint()
    assert repro_torch.validate_acg(targets.get_target(name),
                                    raise_on_error=False) == []
    assert repro.validate_acg(ref_acg, raise_on_error=False) == []


def test_registry_is_the_reference_registry_and_h100():
    assert repro_torch.available_targets() == \
        sorted(repro.available_targets() + ["h100"])


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("layer", LAYERS)
def test_paper_layer_compiles_as_the_reference(layer, target):
    mine = repro_torch.compile(layer, target)
    ref = repro.compile(layer, ref_target(target))
    assert mine.cycles() == ref.cycles() > 0
    assert mine.key == ref.key
    assert repro_torch.compile_key(layer, target) == ref.key
    assert mine.schedule_notes == ref.schedule_notes


@pytest.mark.parametrize("target, layer", LISTINGS)
def test_small_layer_listing_matches_reference(target, layer):
    mine = repro_torch.compile(SMALL[layer](library), target)
    ref = repro.compile(SMALL[layer](ref_library), ref_target(target))
    assert mine.key == ref.key
    _same_program(mine, ref)


@pytest.mark.parametrize("target, layer", RUNS)
def test_stream_run_matches_reference(target, layer):
    """The stream machine's outputs and cycle counts, and the functional
    interpreter's outputs, are bit-equal to the reference's; both pass
    ``verify`` against the codelet's numpy oracle."""
    mine = repro_torch.compile(SMALL[layer](library), target)
    ref = repro.compile(SMALL[layer](ref_library), ref_target(target))
    ins = random_inputs(SMALL[layer](library), np.random.default_rng(0),
                        0, 5)
    got, want = mine.run(ins), ref.run(ins)
    assert sorted(got.outputs) == sorted(want.outputs)
    for k in want.outputs:
        np.testing.assert_array_equal(got.outputs[k], want.outputs[k])
    assert (got.serial_cycles, got.packed_cycles) == \
        (want.serial_cycles, want.packed_cycles)
    assert mine.verify(ins) and ref.verify(ins)
    # the interpreter runs the schedule before vectorize / unroll / pack
    ig = _outcome(lambda: interp.run(
        scheduler.schedule(SMALL[layer](library), mine.acg), mine.acg, ins))
    iw = _outcome(lambda: ref_interp.run(
        ref_scheduler.schedule(SMALL[layer](ref_library), ref.acg), ref.acg,
        ins))
    if target.startswith("h100"):
        # the reference's write-back from RF through SMEM names a local
        # that no transfer allocated: its interpreter raises there
        assert isinstance(ig, tuple) and ig == iw and ig[0] == "KeyError"
        return
    assert sorted(ig) == sorted(iw)
    for k in iw:
        np.testing.assert_array_equal(ig[k], iw[k])


def _outcome(run):
    """``run()``'s outputs, or (its exception's type name, message)."""
    try:
        return run()
    except Exception as e:  # compared with the reference's outcome
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("target, layer", [
    ("hvx", "gemm_bf16"), ("dnnweaver", "add_f32"), ("example", "add"),
    ("h100", "relu")])
def test_broken_covenant_raises_the_reference_violations(target, layer):
    build = SMALL.get(layer, lambda lib: lib.relu(64))
    with pytest.raises(repro_torch.CovenantError) as mine:
        repro_torch.compile(build(library), target)
    with pytest.raises(repro.CovenantError) as ref:
        repro.compile(build(ref_library), ref_target(target))
    assert [(v.kind, v.subject, v.message, v.hint)
            for v in mine.value.violations] == \
        [(v.kind, v.subject, v.message, v.hint)
         for v in ref.value.violations]
    assert mine.value.violations
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("variant", ["dnnweaver@pe=32x32",
                                     "hvx@issue_slots=8",
                                     "h100@SMEM.depth=896"])
@pytest.mark.parametrize("layer", ["BERT-LG-GEMM1", "DLRM-FC1",
                                   "MobileNetV3-CONV1"])
def test_derived_variant_cycles_match(variant, layer):
    mine = repro_torch.compile(layer, variant)
    ref = repro.compile(layer, ref_target(variant))
    assert mine.acg.name == variant
    assert mine.cycles() == ref.cycles() > 0
    assert mine.key == ref.key


@pytest.mark.parametrize("strategy, seed, target, layer", [
    ("evolutionary", 0, "hvx", "DLRM-FC1"),
    ("evolutionary", 3, "h100", "BERT-LG-ATN4-GEMM"),
    ("beam", 0, "dnnweaver", "DLRM-FC2"),
    ("random", 1, "tpu_v5e", "ResNet50-FC1"),
    ("grid", 0, "h100", "InceptionV3-FC1"),
])
def test_seeded_search_matches_reference(strategy, seed, target, layer):
    opts = dict(strategy=strategy, generations=3, population=8, seed=seed)
    mine = repro_torch.compile(layer, target, repro_torch.CompileOptions(
        search=repro_torch.SearchOptions(**opts)))
    ref = repro.compile(layer, ref_target(target), repro.CompileOptions(
        search=repro.SearchOptions(**opts)))
    assert mine.key == ref.key
    assert mine.search.gain == ref.search.gain
    assert mine.search.summary() == ref.search.summary()
    assert mine.cycles() == ref.cycles()


_COMPILE = """
import json, repro_torch
art = repro_torch.compile("DLRM-FC1", "h100")
print(json.dumps({"cycles": art.cycles(), "executed": art.ctx.executed,
                  "stats": repro_torch.cache_stats()}))
"""


def _compile_in_fresh_process(**env) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    out = subprocess.run([sys.executable, "-c", _COMPILE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_store_round_trip_in_a_fresh_process(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    cold = _compile_in_fresh_process(REPRO_TORCH_CACHE_DIR=str(tmp_path))
    assert cold["stats"]["store_misses"] == 1 and cold["executed"]
    warm = _compile_in_fresh_process(REPRO_TORCH_CACHE_DIR=str(tmp_path))
    assert warm["executed"] == []
    assert warm["stats"]["store_hits"] > 0
    assert warm["cycles"] == cold["cycles"] == \
        repro.compile("DLRM-FC1", ref_target("h100")).cycles()


def test_reference_store_is_not_served_to_the_port(tmp_path, monkeypatch):
    """An entry the reference wrote under the same key is stale to the
    port (another compiler signature), and the reference's
    ``REPRO_CACHE_DIR`` names no store of the port's."""
    monkeypatch.delenv("REPRO_TORCH_CACHE_DIR", raising=False)
    repro.clear_cache()
    ref = repro.compile("DLRM-FC1", ref_target("h100"),
                        repro.CompileOptions(store=str(tmp_path)))
    assert ref.key + ".json" in os.listdir(tmp_path)
    alone = _compile_in_fresh_process(REPRO_CACHE_DIR=str(tmp_path))
    assert alone["stats"]["store_hits"] == 0
    assert alone["stats"]["store_misses"] == 0   # no store at all
    shared = _compile_in_fresh_process(REPRO_TORCH_CACHE_DIR=str(tmp_path))
    assert shared["stats"]["store_hits"] == 0
    assert shared["stats"]["store_misses"] == 1 and shared["executed"]
    assert shared["cycles"] == alone["cycles"] == ref.cycles()
