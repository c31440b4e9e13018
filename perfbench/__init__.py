"""The benchmark of ``rabit_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout, on a machine that holds the cards the cell asks for:

    python3 -m perfbench.run --workload higgs.tree --seed 7 --seconds 20 \\
        --trace 0

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: a dataset's published shape;
* ``traffic/<mix>.json``: the parameters of a tree-growing mix, which
  ``nodes.py`` turns into the histogram calls of each tree;
* ``metrics/<metric>.py``: a ``read(reading)`` that returns the metric's
  value, or None where the run gave it nothing to read.

The yardstick lives here too: the inputs made from ``--seed``
(``data.py``), the bytes floors and the card's peaks (``floors.py``), the
profiler's reduction (``trace.py``), the plain reference (``reference.py``)
and the comparison that decides ``correct`` (``check.py``). Nothing here
imports JAX or the JAX package; only ``rank.py`` imports the port.
"""
