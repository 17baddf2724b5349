"""Regenerate README.md's measured-numbers block from a bench.py JSON.

Every performance number in the README is read from the benchmark's JSON
line, so the README cannot drift from what was measured.  A field the JSON
lacks renders as "not measured"; with no JSON at all the block says that
nothing has been measured.

Usage: python scripts/update_readme_bench.py <bench_json_file_or_->
       (pass '-' to read the JSON line from stdin; the last line that
       parses as a JSON object is used)
"""

import json
import pathlib
import re
import sys

BEGIN = "<!-- BENCH:BEGIN"
END = "<!-- BENCH:END -->"
NOT_MEASURED = "not measured"


def fmt_block(d: dict) -> str:
    def num(key, fmt="{:,.0f}", unit=""):
        v = d.get(key)
        return NOT_MEASURED if v is None else f"**{fmt.format(v)}{unit}**"

    def spread(key):
        s = d.get(key + "_spread")
        return f" (spread {s[0]:,.0f}–{s[1]:,.0f})" if s else ""

    dev = d.get("device")
    where = (
        f"{dev['kind']} x{dev['count']}, card `{d.get('card', '?')}`"
        if dev else NOT_MEASURED
    )
    lines = [
        f"Device: {where}.  Numbers from `python bench.py`, regenerated by "
        f"`scripts/update_readme_bench.py`.",
        "",
        f"- batched solve, N=50, full constraints, batch "
        f"{d.get('batch', NOT_MEASURED)}: {num('value', unit=' solves/s')}"
        f"{spread('value')}",
        f"- single solve (`solver.run_step_jit`): "
        f"{num('single_solve_ms', '{:.2f}', ' ms')}; batched route at B=1: "
        f"{num('batched_b1_solve_ms', '{:.2f}', ' ms')}",
        f"- Monte-Carlo pipeline: {num('mc_scenarios_per_sec', unit=' scenarios/s')}"
        f"{spread('mc_scenarios_per_sec')}",
        f"- full-stack closed loop: "
        f"{num('full_stack_cycles_per_sec', unit=' cycles/s')}"
        f"{spread('full_stack_cycles_per_sec')}",
        f"- closed loop, shared world: "
        f"{num('closed_loop_cycles_per_sec', unit=' cycles/s')}"
        f"{spread('closed_loop_cycles_per_sec')}",
    ]
    return "\n".join(lines)


def apply_to_text(text: str, d: dict) -> str:
    """Replace the README's BENCH:BEGIN..END block with one rendered from
    the bench dict ``d``.  Raises ValueError when the markers are absent."""
    pat = re.compile(
        re.escape(BEGIN) + r".*?" + re.escape(END), flags=re.DOTALL
    )
    if not pat.search(text):
        raise ValueError("README.md bench markers not found")
    block = (
        BEGIN
        + " — generated by scripts/update_readme_bench.py from the\n"
        + "latest bench.py JSON (one source of truth; do not hand-edit) -->\n"
        + fmt_block(d)
        + "\n"
        + END
    )
    return pat.sub(lambda _: block, text)


def last_json_object(raw: str) -> dict:
    """The last line of ``raw`` that parses as a JSON object."""
    for line in reversed(raw.strip().splitlines()):
        try:
            d = json.loads(line)
        except ValueError:
            continue
        if isinstance(d, dict):
            return d
    raise ValueError("no JSON object in the bench output")


def main():
    src = sys.argv[1] if len(sys.argv) > 1 else "-"
    raw = sys.stdin.read() if src == "-" else pathlib.Path(src).read_text()
    readme = pathlib.Path(__file__).resolve().parents[1] / "README.md"
    try:
        readme.write_text(apply_to_text(readme.read_text(), last_json_object(raw)))
    except ValueError as e:
        sys.exit(str(e))
    print("README.md bench block regenerated from", src)


if __name__ == "__main__":
    main()
