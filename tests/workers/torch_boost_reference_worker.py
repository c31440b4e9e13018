"""``examples/py/boosted_trees.py`` as it is, under ``rabit_tpu``, with its
model printed: the reference for the port's ``tools/boosted_trees.py``.
Runs the example's ``main`` and writes the trees of the last checkpoint
(every round checkpoints the whole model) as ``ref-rank<r>.json`` into
``RABIT_RESULT_DIR``, and prints them after ``REF-JSON``."""

import importlib.util
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, ROOT)

import rabit_tpu  # noqa: E402


def main() -> None:
    spec = importlib.util.spec_from_file_location(
        "boosted_trees_example",
        os.path.join(ROOT, "examples", "py", "boosted_trees.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    last = {}
    checkpoint = rabit_tpu.checkpoint

    def keep(model, local_model=None):
        last["trees"] = [list(t) for t in model]
        last["rank"] = rabit_tpu.get_rank()
        checkpoint(model, local_model)

    rabit_tpu.checkpoint = keep
    example.main()
    # the ranks share the launcher's stdout: the test reads the file
    out_dir = os.environ["RABIT_RESULT_DIR"]
    path = os.path.join(out_dir, f"ref-rank{last['rank']}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(last, f)
    os.replace(path + ".tmp", path)
    sys.stdout.write("REF-JSON " + json.dumps(last) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
