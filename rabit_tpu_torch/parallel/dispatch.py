"""Allreduce schedule selection for the PyTorch port.

Only the reference's crossover so far (``rabit_tpu/parallel/dispatch.py``):
payloads of at least ``RING_MINCOUNT_DEFAULT`` elements take the ring,
smaller ones the tree (reduce_ring_mincount, allreduce_base.h:532-534).
The measured dispatch table, the wire gate and skew adaptation are not
ported yet.
"""

RING_MINCOUNT_DEFAULT = 32 << 10
