"""A checkout of the benchmark at test size: the committed metrics and
mixes, and small configurations added as new files, as a later change
would add them."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# tiny: 64 bins, NCCL's tree on the card (gloo's all_reduce here); wide:
# 16,384 bins, 32,768 floats a call, so the port's ring at two ranks
CONFIGS = {
    "tiny": {"rows": 60000, "features": 4, "max_bin": 16},
    "wide": {"rows": 120000, "features": 4, "max_bin": 4096},
}
CELLS = [
    ("tiny.tree", "tiny", "tree_depthwise", 1),
    ("tiny.stumps", "tiny", "stumps", 1),
    ("wide.tree.w2", "wide", "tree_depthwise", 2),
    ("tiny.tree.w64", "tiny", "tree_depthwise", 64),
]


def make_root(dest: Path) -> Path:
    """``dest`` holding BENCHMARK.json and the benchmark's data files, with
    the test cells added to them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = dest / "perfbench"
    for sub in ("traffic", "metrics", "configs"):
        shutil.copytree(ROOT / "perfbench" / sub, pb / sub)
    for name, cfg in CONFIGS.items():
        (pb / "configs" / f"{name}.json").write_text(
            json.dumps(dict(cfg, name=name, reduced=[])))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"perfbench/configs/{name}.json",
                                 "reduced": [], "why": "test size"})
    bench["workloads"] += [{"name": n, "config": c, "traffic": t, "chips": p,
                            "why": "test size"} for n, c, t, p in CELLS]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest



def last_line(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
