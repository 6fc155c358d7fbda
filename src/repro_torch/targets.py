"""``repro_torch.targets`` — the string-addressable accelerator-target
registry, and the port's ``h100`` covenant (``H100``, ``H100_SPEC``).

Everywhere the driver API accepts a target, it accepts a *name* resolved
here: bundled covenant specs (``example``, ``dnnweaver``, ``hvx``,
``tpu_v5e``, ``h100``), specs you ``register()``, and derived-variant
names (``"dnnweaver@pe=32x32"``, ``"hvx@issue_slots=8,VRF.depth=64"``)
that ``spec.derive()`` materializes on the fly — the paper's adaptability
claim ("design changes without complete compiler redevelopment") as a
runnable sweep over architecture families.

    import repro_torch
    from repro_torch import targets
    from repro_torch.core.spec import acg_spec, scap, scu, sedge, smem, sop

    targets.register(acg_spec("mynpu", memories=[...], computes=[...],
                              edges=[...]))
    art = repro_torch.compile("BERT-LG-GEMM1", "mynpu")          # by name
    art32 = repro_torch.compile("BERT-LG-GEMM1", "mynpu@pe=32x32")  # variant

As a module, it validates every bundled spec::

    PYTHONPATH=src python -m repro_torch.targets            # validate + sweep
    PYTHONPATH=src python -m repro_torch.targets --no-sweep # structural only

The port's copy of ``repro.targets``, with the same logic; the ``h100``
spec itself is ``core.h100``'s.
"""
from __future__ import annotations

from .core.covenant import (CovenantError, CovenantViolation, check_covenant,
                            validate_acg)
from .core.h100 import H100, H100_SPEC, h100_acg
from .core.spec import (ACGSpec, SpecError, acg_spec, parse_overrides,
                        validate_spec)
from .core.targets import (BUNDLED_SPECS, TARGETS, get_spec, get_target,
                           list_targets, register_spec)

# The facade API: names are the addressing scheme everywhere.
get = get_target
register = register_spec


def list():  # noqa: A001 - deliberate: ``targets.list()`` reads well
    """Sorted names of every registered target."""
    return list_targets()


def derive(name: str, **overrides) -> ACGSpec:
    """Derived variant of a registered target, as a spec:
    ``derive("dnnweaver", pe="32x32")``."""
    return get_spec(name).derive(**overrides)


# ---------------------------------------------------------------------------
# validate every bundled spec + a small derived-variant sweep
# ---------------------------------------------------------------------------


def validate_bundled(sweep: bool = True, emit=print) -> int:
    """Load every bundled spec, run ``validate_spec`` + ``validate_acg``,
    and (optionally) push a 2-variant x 3-layer derived sweep through the
    driver as a smoke test.  Returns the number of problems found."""
    from .core import driver

    problems = 0
    for name, spec in sorted(BUNDLED_SPECS.items()):
        errs = validate_spec(spec, raise_on_error=False)
        if not errs:
            try:
                acg = get_target(name)
            except (SpecError, KeyError) as e:
                errs = getattr(e, "problems", None) or [str(e)]
            else:
                errs = validate_acg(acg, raise_on_error=False)
                if spec.fingerprint() != acg.to_spec().fingerprint():
                    errs.append(
                        "spec does not round-trip through ACG.from_spec")
        for e in errs:
            emit(f"FAIL {name}: {e}")
        problems += len(errs)
        if not errs:
            emit(f"ok   {name}: valid spec, fingerprint "
                 f"{spec.fingerprint()[:12]}, {len(spec.mnemonics)} "
                 f"mnemonics")
    if not sweep:
        return problems
    layers = ["DLRM-FC1", "DLRM-FC2", "DLRM-FC3"]
    # variants chosen to perturb the cost report, not just the key: a PE
    # rescale changes compute granularity, an edge re-rate changes the
    # transfer schedule
    variants = ["dnnweaver@pe=32x32", "hvx@edge.L2.VRF.bandwidth=512"]
    pairs = [(layer, v) for v in variants for layer in layers]
    arts = driver.compile_many(pairs)
    for (layer, variant), art in zip(pairs, arts):
        base = driver.compile(layer, variant.partition("@")[0])
        distinct = art.key != base.key and art.cycles() != base.cycles()
        status = "ok  " if distinct else "FAIL"
        if not distinct:
            problems += 1
        emit(f"{status} {layer} @ {variant}: {art.cycles():.0f} cyc "
             f"(base {base.cycles():.0f}), key {art.key[:12]} vs "
             f"{base.key[:12]}")
    return problems


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.targets",
        description="validate the bundled covenant specs")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the derived-variant compile sweep")
    args = ap.parse_args(argv)
    problems = validate_bundled(sweep=not args.no_sweep)
    if problems:
        print(f"targets-validate: {problems} problem(s)")
        return 1
    print("targets-validate: all bundled specs valid")
    return 0


__all__ = [
    "ACGSpec", "BUNDLED_SPECS", "CovenantError", "CovenantViolation", "H100",
    "H100_SPEC", "SpecError", "TARGETS", "acg_spec", "check_covenant",
    "derive", "get", "get_spec", "get_target", "h100_acg", "list",
    "list_targets", "parse_overrides", "register", "register_spec",
    "validate_acg", "validate_bundled", "validate_spec",
]


if __name__ == "__main__":
    raise SystemExit(_main())
