"""README bench-block regeneration (scripts/update_readme_bench.py).

The README's measured-numbers block is generated from the bench.py JSON
line (one source of truth); these tests lock the renderer so a bench field
rename or marker edit cannot silently break the regeneration path, and a
missing measurement renders as "not measured", never as a number.
"""

import importlib.util
import json
import pathlib

import pytest

_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load():
    spec = importlib.util.spec_from_file_location(
        "update_readme_bench", _ROOT / "scripts" / "update_readme_bench.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The field set of the current bench.py JSON line; the values are made up
# for the formatting assertions and were measured nowhere.
ARTIFACT = {
    "metric": "cilqr_solves_per_sec_N50_full_constraints",
    "value": 123456.7,
    "value_spread": [120000.2, 125000.9],
    "unit": "solves/s",
    "batch": 32768,
    "batched_step_ms": 265.4,
    "mean_lm_iterations": 10.3,
    "single_solve_ms": 4.321,
    "single_solve_ms_spread": [4.2, 4.6],
    "batched_b1_solve_ms": 0.789,
    "kernel_route": True,
    "mc_scenarios_per_sec": 54321.0,
    "mc_scenarios_per_sec_spread": [54000.0, 55000.0],
    "full_stack_cycles_per_sec": 98765.4,
    "full_stack_cycles_per_sec_spread": [98000.0, 99000.0],
    "closed_loop_cycles_per_sec": 1234567.0,
    "closed_loop_cycles_per_sec_spread": [1200000.0, 1250000.0],
    "device": {"platform": "gpu", "kind": "Example GPU", "count": 1},
    "card": "Example GPU, 700.00 W",
}


def test_fmt_block_renders_every_headline_field():
    mod = _load()
    out = mod.fmt_block(ARTIFACT)
    assert "Example GPU x1, card `Example GPU, 700.00 W`" in out
    assert "**123,457 solves/s**" in out
    assert "spread 120,000–125,001" in out
    assert "batch 32768" in out
    assert "**4.32 ms**" in out and "**0.79 ms**" in out
    assert "**54,321 scenarios/s**" in out
    assert "**98,765 cycles/s**" in out and "spread 98,000–99,000" in out
    assert "**1,234,567 cycles/s**" in out
    assert mod.NOT_MEASURED not in out


def test_fmt_block_degrades_without_optional_fields():
    """An empty or partial JSON renders "not measured" for every missing
    number instead of crashing or inventing one."""
    mod = _load()
    out = mod.fmt_block({})
    assert out.count(mod.NOT_MEASURED) >= 7
    assert "**" not in out
    partial = {k: v for k, v in ARTIFACT.items() if not k.startswith("mc_")}
    out = mod.fmt_block(partial)
    assert "Monte-Carlo pipeline: not measured" in out
    assert "**123,457 solves/s**" in out


def test_apply_to_text_roundtrip_and_idempotence():
    mod = _load()
    text = "intro\n" + mod.BEGIN + " old -->\nSTALE NUMBERS\n" + mod.END + "\ntail\n"
    once = mod.apply_to_text(text, ARTIFACT)
    assert "STALE NUMBERS" not in once
    assert once.startswith("intro\n") and once.endswith("\ntail\n")
    assert "**123,457 solves/s**" in once
    assert mod.apply_to_text(once, ARTIFACT) == once  # idempotent
    # the bench prints the card line before the JSON line
    raw = "Example GPU, 700.00 W\n" + json.dumps(ARTIFACT) + "\n"
    assert mod.last_json_object(raw) == ARTIFACT


def test_apply_to_text_requires_markers():
    mod = _load()
    with pytest.raises(ValueError, match="markers not found"):
        mod.apply_to_text("no markers here", ARTIFACT)
    with pytest.raises(ValueError, match="no JSON object"):
        mod.last_json_object("Example GPU, 700.00 W\n")


def test_repo_readme_matches_renderer_contract():
    """The checked-in README block carries the markers and is exactly the
    renderer's product for the current state of measurement (none yet:
    every number "not measured")."""
    mod = _load()
    text = (_ROOT / "README.md").read_text()
    assert mod.BEGIN in text and mod.END in text
    assert mod.apply_to_text(text, {}) == text
    out = mod.apply_to_text(text, ARTIFACT)
    assert out.count(mod.BEGIN) == 1 and out.count(mod.END) == 1
    assert text.split(mod.BEGIN)[0] == out.split(mod.BEGIN)[0]
    assert text.split(mod.END)[-1] == out.split(mod.END)[-1]
