"""One collective stream under either package, for a bit-for-bit
comparison: ``rabit_tpu`` (robust engine, XLA data plane) or
``rabit_tpu_torch`` (robust engine, torch data plane), chosen by
``COMPARE_PKG``. Every round reduces seeded inputs (f32 SUM, f64 SUM,
int32 MAX) and broadcasts an object; each round's results join the
checkpointed model, so a rank killed and respawned recovers the earlier
rounds' results with the model and replays the rest. At the end each rank
pickles the model's results to ``COMPARE_OUT/r<rank>.pkl``.

argv: key=value params forwarded to the engine (mock=..., etc.)
env:  COMPARE_PKG (rabit_tpu | rabit_tpu_torch), COMPARE_OUT, N_ITER
      (default 5), KILL_IN_DATAPLANE=rank,iter (as in
      torch_recover_worker.py: the rank's first attempt ends inside the
      f32 SUM of that iteration, after the engine's consensus)
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

PKG = os.environ["COMPARE_PKG"]
if PKG == "rabit_tpu":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import rabit_tpu as rabit  # noqa: E402
else:
    import rabit_tpu_torch as rabit  # noqa: E402

import numpy as np  # noqa: E402


def _kill_point():
    spec = os.environ.get("KILL_IN_DATAPLANE")
    if not spec or os.environ.get("RABIT_NUM_TRIAL", "0") != "0":
        return None
    return tuple(int(v) for v in spec.split(","))


def one_round(rank: int, world: int, it: int) -> list:
    rng = np.random.default_rng(1000 * it + rank)
    f32 = rng.standard_normal(1003).astype(np.float32)
    f64 = rng.standard_normal(501)
    i32 = rng.integers(-10_000, 10_000, 257).astype(np.int32)
    kill = _kill_point()

    def prep(d):
        if kill == (rank, it):
            os._exit(254)
        d[:] = f32

    out = [rabit.allreduce(np.zeros_like(f32), rabit.SUM, prepare_fun=prep),
           rabit.allreduce(f64, rabit.SUM),
           rabit.allreduce(i32, rabit.MAX)]
    root = it % world
    obj = rabit.broadcast({"it": it, "v": f64[:7] * root}
                          if rank == root else None, root)
    out.append(np.asarray(obj["v"]))
    return [(a.dtype.str, a.tobytes()) for a in out]


def main() -> None:
    rabit.init()
    rank, world = rabit.get_rank(), rabit.get_world_size()
    n_iter = int(os.environ.get("N_ITER", "5"))
    version, model = rabit.load_checkpoint()
    model = model or {"results": []}
    assert len(model["results"]) == version, (version, model)
    for it in range(version, n_iter):
        model["results"].append(one_round(rank, world, it))
        rabit.checkpoint(model)
    eng = rabit._engine
    doc = {"results": model["results"], "epoch": eng.world_epoch}
    dp = getattr(eng, "dataplane", None)   # the port's data plane
    if dp is not None:
        doc.update(backend=dp.backend, formations=dp.formations)
    rabit.finalize()
    with open(os.path.join(os.environ["COMPARE_OUT"], f"r{rank}.pkl"),
              "wb") as f:
        pickle.dump(doc, f)
    print(f"COMPARE-OK rank={rank} world={world} pkg={PKG}", flush=True)


if __name__ == "__main__":
    main()
