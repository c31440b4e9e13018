"""MPI engine worker (tests/test_torch_mpi_engine.py): one program of
collectives through ``rabit_engine=mpi``, run under ``mpirun`` by
either package, so that both engines' results can be held bit for bit.

``MPI_PKG`` names the package (``rabit_tpu_torch``, the port, or
``rabit_tpu``, the JAX package, whose native engine takes the same
variant). ``init(["rabit_engine=mpi"])`` goes through ``"auto"`` with no
tracker. The inputs come from numpy's seed (``MPI_SEED``, the rank):

- f32, f64, i32 and u8 payloads under SUM, MAX, MIN and BITOR (BITOR on
  the integers only), one f32 SUM with a ``prepare_fun`` that fills the
  buffer lazily;
- a custom reducer through the C interface's ``RbtAllreduceRaw``: 16-byte
  elements (two f64), ``(a, b) + (c, d) = (max(a, c), b + d)``;
- a broadcast from root ``1 % world`` of a pickled object;
- ``checkpoint`` twice: ``version_number`` after each and what
  ``load_checkpoint`` gives (the MPI engine only counts versions);
- after ``finalize``, whether MPI is finalized (``MPI_Finalized``).

With ``MPI_OWNER=app`` the program calls ``MPI_Init`` itself before
``init`` and ``MPI_Finalize`` after ``finalize``: the engine must leave
MPI as it found it.

``MPI_LIBRARY`` names the MPI library the engine links, for the
program's own ``MPI_Init``/``MPI_Finalized``. Each rank writes
``rank<r>.npz`` into ``RABIT_RESULT_DIR``.
"""

import ctypes
import importlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

N = 1000
DTYPES = ("float32", "float64", "int32", "uint8")
REDUCE_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_size_t, ctypes.c_void_p)


OPS = ("sum", "max", "min", "bitor")


def payload(rng, dtype: str) -> np.ndarray:
    if dtype.startswith("float"):
        return rng.standard_normal(N).astype(dtype)
    if dtype == "int32":
        return rng.integers(-1 << 20, 1 << 20, N, dtype=np.int32)
    return rng.integers(0, 256, N, dtype=np.uint8)


def inputs(rank: int, seed: int) -> dict:
    """Rank ``rank``'s inputs, by name: ``<dtype>_<op>`` payloads,
    ``lazy_sum`` (the prepare_fun's), ``custom`` ([N, 2] f64) and
    ``blob`` (the broadcast root's bytes)."""
    rng = np.random.default_rng([seed, rank])
    d = {}
    for dtype in DTYPES:
        for op in OPS:
            if not (op == "bitor" and dtype.startswith("float")):
                d[f"{dtype}_{op}"] = payload(rng, dtype)
    d["lazy_sum"] = payload(rng, "float32")
    d["custom"] = np.ascontiguousarray(np.stack(
        [rng.standard_normal(N),
         rng.integers(-100, 100, N).astype(np.float64)], 1))
    d["blob"] = np.frombuffer(rng.bytes(4096), np.uint8)
    return d


def max_sum(dst, src, count, _ctx) -> None:
    d = np.ctypeslib.as_array(ctypes.cast(dst, ctypes.POINTER(
        ctypes.c_double)), (count, 2))
    s = np.ctypeslib.as_array(ctypes.cast(src, ctypes.POINTER(
        ctypes.c_double)), (count, 2))
    d[:, 0] = np.maximum(d[:, 0], s[:, 0])
    d[:, 1] += s[:, 1]


def custom_allreduce(lib, buf: np.ndarray) -> None:
    """``buf`` ([n, 2] f64) reduced by ``max_sum`` over the world."""
    lib.RbtAllreduceRaw.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, REDUCE_FN,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p]
    lib.RbtAllreduceRaw.restype = ctypes.c_int
    fn = REDUCE_FN(max_sum)
    rc = lib.RbtAllreduceRaw(buf.ctypes.data_as(ctypes.c_void_p), 16,
                             buf.shape[0], fn, None, None, None, b"")
    if rc != 0:
        raise RuntimeError(lib.RbtGetLastError().decode())


def finalized(libmpi) -> bool:
    flag = ctypes.c_int(0)
    libmpi.MPI_Finalized(ctypes.byref(flag))
    return bool(flag.value)


def main() -> None:
    rabit = importlib.import_module(os.environ.get("MPI_PKG",
                                                   "rabit_tpu_torch"))
    app_owned = os.environ.get("MPI_OWNER") == "app"
    # the MPI library the engine links (find_mpi's), named by the test
    libmpi = ctypes.CDLL(os.environ["MPI_LIBRARY"])
    if app_owned:
        libmpi.MPI_Init(None, None)
    rabit.init(["rabit_engine=mpi"])
    rank, world = rabit.get_rank(), rabit.get_world_size()
    print(f"rank {rank} core {rabit._engine._lib._name}", flush=True)
    ins = inputs(rank, int(os.environ.get("MPI_SEED", "5")))
    out = {"world": np.array([world]),
           "distributed": np.array([rabit.is_distributed()])}
    ops = {"sum": rabit.SUM, "max": rabit.MAX, "min": rabit.MIN,
           "bitor": rabit.BITOR}
    for key, x in ins.items():
        dtype, _, op = key.partition("_")
        if dtype in DTYPES:
            out[key] = rabit.allreduce(x, ops[op])

    def fill(b):
        b[:] = ins["lazy_sum"]
    out["lazy_sum"] = rabit.allreduce(np.zeros(N, np.float32), rabit.SUM,
                                      prepare_fun=fill)
    pairs = ins["custom"].copy()
    custom_allreduce(rabit._engine._lib, pairs)
    out["custom"] = pairs

    root = 1 % world
    obj = {"rank": rank, "blob": ins["blob"].tobytes()} \
        if rank == root else None
    out["bcast"] = np.frombuffer(rabit.broadcast(obj, root)["blob"],
                                 np.uint8)

    versions = [rabit.version_number()]
    for i in range(2):
        rabit.checkpoint({"round": i})
        versions.append(rabit.version_number())
    version, model = rabit.load_checkpoint()
    out["versions"] = np.array(versions + [version])
    out["model_none"] = np.array([model is None])
    rabit.tracker_print(f"mpi worker world {world} done")
    rabit.finalize()
    out["finalized"] = np.array([finalized(libmpi)])
    if app_owned:
        libmpi.MPI_Finalize()
    np.savez(os.path.join(os.environ["RABIT_RESULT_DIR"], f"rank{rank}.npz"),
             **out)


if __name__ == "__main__":
    main()
