"""The port's copy of tests/test_fuzz_lint.py: tools/fuzz_lint.py, pointed
at the port's suite (tests/test_torch_sim_fuzz.py): every registered
sim-fuzz kind must keep an always-on (non-slow) smoke rung in tier-1 — a
kind living only in the slow sweep is silent coverage loss. Every verdict
is also held to the reference tool's on the same file."""
from __future__ import annotations

import textwrap

from plenum_tpu.tools.fuzz_lint import run_lint as ref_lint
from plenum_tpu_torch.tools.fuzz_lint import run_lint


def _held(path: str) -> dict:
    """The port's lint of `path`, equal to the reference's."""
    out = run_lint(path)
    assert out == ref_lint(path)
    return out


def test_fuzz_suite_smoke_coverage():
    """The real suite: every scenario runner (base kinds AND the
    run_*_with_* compositions) is referenced by a non-slow test."""
    out = _held(run_lint.__defaults__[0])
    assert out["file"].endswith("test_torch_sim_fuzz.py")
    assert out["check"] == "ok", out["problems"]
    assert out["scenarios"] >= 10        # the kinds this repo has grown
    assert out["smoke_covered"] == out["scenarios"]
    # the reshard kind introduced with live split/merge is registered
    assert "run_reshard_fuzz_scenario" in out["kinds"]
    # the federated ring's kind
    assert "run_crypto_host_down_scenario" in out["kinds"]
    # the Proof-CDN kind (a lying edge cache can deny, never forge)
    assert "run_lying_edge_scenario" in out["kinds"]
    # every kind of the reference suite is ported, with the same smoke
    # rungs
    ref = ref_lint()["kinds"]
    assert {k: v["smoke"] for k, v in out["kinds"].items()} == \
        {k: v["smoke"] for k, v in ref.items()}


def test_fuzz_lint_catches_sweep_only_kind(tmp_path):
    """A scenario with ONLY a slow sweep must fail the lint; adding a
    smoke rung clears it."""
    bad = tmp_path / "bad_fuzz.py"
    bad.write_text(textwrap.dedent("""
        import pytest

        def run_orphan_scenario(seed):
            pass

        @pytest.mark.slow
        def test_orphan_fuzz():
            run_orphan_scenario(1)
    """))
    out = _held(str(bad))
    assert out["check"] == "FAIL"
    assert any("run_orphan_scenario" in p for p in out["problems"])

    good = tmp_path / "good_fuzz.py"
    good.write_text(textwrap.dedent("""
        import pytest

        def run_orphan_scenario(seed):
            pass

        @pytest.mark.slow
        def test_orphan_fuzz():
            run_orphan_scenario(1)

        def test_orphan_smoke():
            run_orphan_scenario(2)
    """))
    out = _held(str(good))
    assert out["check"] == "ok", out["problems"]


def test_fuzz_lint_smoke_via_lambda_counts(tmp_path):
    """The suite's idiom wraps scenarios in lambdas (force_rung pinning);
    the AST walk must see through them."""
    f = tmp_path / "lambda_fuzz.py"
    f.write_text(textwrap.dedent("""
        def run_thing_scenario(seed, force_rung=None):
            pass

        def _run_with_artifacts(fn, seed):
            fn(seed)

        def test_thing_smoke():
            _run_with_artifacts(
                lambda s: run_thing_scenario(s, force_rung=0), 1)
    """))
    out = _held(str(f))
    assert out["check"] == "ok", out["problems"]


def test_fuzz_lint_naming_drift_fails(tmp_path):
    """If the suite's naming convention drifts so discovery finds
    nothing, the lint fails loudly instead of vacuously passing."""
    f = tmp_path / "empty_fuzz.py"
    f.write_text("def helper():\n    pass\n")
    out = _held(str(f))
    assert out["check"] == "FAIL"
