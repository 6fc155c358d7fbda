"""The launch layer on the port's Covenant compile driver, against the
reference's: ``launch.layers.layer_report`` and ``variant_report`` print
the reference's tables row for row (the driver's cache counts apart),
``compile_layer_gemms`` gives the reference's cycles against ``h100``
too, and ``launch.serve`` / ``launch.train`` take ``--accel-target``
(any registered or derived name; an unknown one exits 2) and serve
``--accel-search``.
"""
import tempfile

import pytest

import repro
from repro import configs as ref_configs
from repro.core.spec import ACGSpec as RefACGSpec
from repro.launch import layers as ref_layers

import repro_torch
from repro_torch import configs
from repro_torch.launch import layers
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.targets import H100, H100_SPEC

SEARCH = dict(generations=3, population=8)
CASES = [("qwen3-0.6b", False, 4), ("qwen3-0.6b", False, 4096),
         ("olmoe-1b-7b", True, 64), ("deepseek-moe-16b", True, 64)]


def _cfgs(arch, smoke):
    return (configs.get_config(arch, smoke=smoke),
            ref_configs.get_config(arch, smoke=smoke))


def _table(text: str) -> tuple[list[str], str]:
    """(every line but the last, the last line up to its cache counts)."""
    lines = text.splitlines()
    return lines[:-1], lines[-1].split("(cache hits=")[0]


@pytest.mark.parametrize("search", [False, True])
@pytest.mark.parametrize("arch, smoke, tokens", CASES)
def test_layer_report_prints_the_reference_table(arch, smoke, tokens,
                                                 search):
    cfg, ref_cfg = _cfgs(arch, smoke)
    mine = layers.layer_report(cfg, tokens, "hvx", repro_torch.CompileOptions(
        search=repro_torch.SearchOptions(**SEARCH) if search else None))
    ref = ref_layers.layer_report(ref_cfg, tokens, "hvx",
                                  repro.CompileOptions(
        search=repro.SearchOptions(**SEARCH) if search else None))
    assert _table(mine) == _table(ref)
    assert mine.splitlines()[0] == f"[covenant] {cfg.name} @ hvx, " \
                                   f"tokens={tokens}"
    assert ("search_gain=x" in mine) == search
    # on the CPU, or with no device, the rows carry no card times
    cpu = layers.layer_report(cfg, tokens, "h100", device="cpu")
    assert "predicted" not in cpu and "cuda" not in cpu


@pytest.mark.parametrize("arch, smoke, tokens", CASES)
def test_variant_report_prints_the_reference_table(arch, smoke, tokens):
    cfg, ref_cfg = _cfgs(arch, smoke)
    names = ["hvx", "dnnweaver", "dnnweaver@pe=32x32", "tpu_v5e"]
    assert layers.variant_report(cfg, tokens, names) == \
        ref_layers.variant_report(ref_cfg, tokens, names)


@pytest.mark.parametrize("tokens", [4, 4096])
def test_h100_block_gemms_cost_the_reference_cycles(tokens):
    """Against ``h100`` (read by the reference as data), full-width qwen3's
    block GEMMs cost the reference's cycles, and the prediction spreads
    them over the card's SMs at its tensor-core clock."""
    cfg, ref_cfg = _cfgs("qwen3-0.6b", False)
    spec = RefACGSpec.from_dict(H100_SPEC.to_dict())
    mine = layers.compile_layer_gemms(cfg, tokens)
    ref = ref_layers.compile_layer_gemms(ref_cfg, tokens, spec)
    assert [(g.name, a.cycles()) for g, a in mine] == \
        [(g.name, a.cycles()) for g, a in ref]
    for _, art in mine:
        ms = layers.predicted_ms(art.cycles())
        assert ms == pytest.approx(
            art.cycles() / (H100["clock_hz"] * H100["sms"]) * 1e3)


@pytest.mark.parametrize("extra, header", [
    (["--accel-target", "hvx", "--accel-search"], "@ hvx, tokens=4"),
    (["--accel-target", "dnnweaver@pe=32x32"],
     "@ dnnweaver@pe=32x32, tokens=4"),
    ([], "@ h100, tokens=4"),
])
def test_serve_cli_takes_any_covenant(capsys, extra, header):
    stats = serve_main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                        "--requests", "2", "--max-new", "3"] + extra)
    out = capsys.readouterr().out
    assert f"[covenant] qwen3-0.6b {header}" in out
    assert "block total" in out
    assert ("search_gain=x" in out) == ("--accel-search" in extra)
    assert stats["new_tokens"] > 0
    assert not any(stats["launches"].values())


def test_train_cli_takes_any_covenant(capsys):
    with tempfile.TemporaryDirectory() as d:
        stats = train_main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                            "cpu", "--steps", "1", "--seq-len", "16",
                            "--global-batch", "2", "--ckpt-every", "0",
                            "--ckpt-dir", d, "--accel-target", "tpu_v5e"])
    out = capsys.readouterr().out
    assert "[covenant] qwen3-0.6b @ tpu_v5e, tokens=32" in out
    assert "block total" in out
    assert stats["report"].steps_run == 1


@pytest.mark.parametrize("main", [serve_main, train_main])
@pytest.mark.parametrize("target", ["tpu_v6", "hvx@bogus=1",
                                    "dnnweaver@pe=3x"])
def test_unknown_accel_target_exits_2(capsys, main, target):
    with pytest.raises(SystemExit) as e:
        main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
              "--accel-target", target])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"--accel-target {target!r}" in err
