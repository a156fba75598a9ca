"""Subprocess worker of tests/test_torch_parallel.py: one rank of a gloo
group on the CPU, running every data-parallel scenario the tests read.

Run as:  python tests/_torch_dp_worker.py <coordinator> <num_procs> <pid> \\
             <inputs.pkl> <result.pkl>

Joins the group through ``specenh_torch.parallel.multihost
.initialize_distributed`` (a 50 s timeout on every collective, so a hang
fails the test instead of stopping the suite), writes its ``host_shard`` of
a fixed 5-shot campaign into its own store, then runs the scenarios on
the inputs' weights and tiles and pickles, per scenario, its losses,
histories and final parameters for the parent to hold against the JAX
package, the single-process port and the other rank.  Imports nothing of
the JAX package.
"""

import os
import pickle
import sys

import numpy as np
import torch


def _params(state) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.model.state_dict().items()}


def main() -> None:
    coordinator, n_procs, pid, inputs_path, result_path = sys.argv[1:6]
    n_procs, pid = int(n_procs), int(pid)
    torch.set_num_threads(1)

    from specenh_torch import ModelConfig, TrainConfig
    from specenh_torch import train as T
    from specenh_torch.io.store import SpectrogramStore
    from specenh_torch.parallel.data_parallel import (_epoch_batches, dp_fit,
                                                      make_dp_eval_step, make_dp_train_step,
                                                      shard_batch)
    from specenh_torch.parallel.dp_kernel import dp_kernel_epoch_for
    from specenh_torch.parallel.mesh import make_mesh
    from specenh_torch.parallel.multihost import host_shard, initialize_distributed

    with open(inputs_path, "rb") as fh:
        inp = pickle.load(fh)
    got_pid, got_n = initialize_distributed(coordinator, n_procs, pid, backend="gloo",
                                            timeout=50)
    mesh = make_mesh(n_procs, device="cpu")
    out = {"pid": got_pid, "n": got_n, "mesh": [mesh.rank, mesh.size, mesh.shape["data"]]}

    shots = [f"30{i}" for i in range(5)]
    mine = host_shard(shots)  # no explicit ids: the group's rank and size
    out["shard"] = mine
    with SpectrogramStore(inp["store"] % pid, "a") as store:
        for shot in mine:
            s = np.full((4, 6), float(shot), np.float32)
            store.write_channel(shot, 1, s, np.arange(4.0), np.arange(6.0), s * 0.5)

    tiny = ModelConfig(filters=(4, 4), kernels=((3, 3), (3, 3)), input_shape=(64, 32, 1))

    def state(cfg, sd, tc=TrainConfig(), dtype=None):
        st = T.create_state(cfg, tc, device="cpu", dtype=dtype)
        st.model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        return st

    # one autograd step on this rank's block of a 16-tile batch, then the
    # eval step on the same blocks
    x, y, m = inp["step"]
    st = state(tiny, inp["tiny1"])
    xb, yb, mb = shard_batch(mesh, x, y, m)
    st, loss = make_dp_train_step(mesh)(st, xb, yb, mb)
    out["step"] = {"loss": float(loss), "eval": float(make_dp_eval_step(mesh)(st, xb, yb, mb)),
                   "params": _params(st)}

    # dp_fit: 10 tiles, batch 5 (-> 6, the last batch 2 rows of padding),
    # validation, 4 epochs; interrupted at 2 and resumed to 4; placements
    x, y, xv, yv = inp["fit"]
    kw = dict(batch_size=5, seed=3)
    st, h = dp_fit(state(tiny, inp["tiny2"]), x, y, mesh, xv, yv, epochs=4, **kw)
    out["fit"] = {"history": h, "params": _params(st)}
    ck = inp["ckpt"]
    st, h = dp_fit(state(tiny, inp["tiny2"]), x, y, mesh, xv, yv, epochs=2, checkpoint_dir=ck,
                   metrics_path=inp["metrics"], **kw)
    out["part"] = {"history": h, "params": _params(st)}
    st, h = dp_fit(state(tiny, inp["tiny2"]), x, y, mesh, xv, yv, epochs=4, checkpoint_dir=ck,
                   resume=True, **kw)
    out["resume"] = {"history": h, "params": _params(st)}
    st, h = dp_fit(state(tiny, inp["tiny2"]), x, y, mesh, xv, yv, epochs=2,
                   dataset_sharding="replicated", **kw)
    out["replicated"] = {"history": h, "params": _params(st)}
    st, h = dp_fit(state(tiny, inp["tiny2"], dtype=torch.bfloat16), x, y, mesh, xv, yv,
                   epochs=2, **kw)
    out["bf16"] = {"history": h, "params": _params(st)}

    # early stopping: lr 0 makes every epoch after the first stale
    x, y = inp["stop"]
    tiny16 = ModelConfig(filters=(4, 4), kernels=((3, 3), (3, 3)), input_shape=(32, 16, 1))
    _, h = dp_fit(state(tiny16, inp["tiny16"], TrainConfig(seed=0, learning_rate=0.0)), x, y,
                  mesh, x[:8], y[:8], epochs=8, batch_size=8, seed=0, patience=1)
    out["stop"] = {"history": h}

    # the kernel epoch (float32 twins here) on 6 flagship tiles in batches
    # of 4, so rank 1's block of batch 2 is all padding
    x, y = inp["kernel"]
    bi, bm = _epoch_batches(len(x), 4, np.arange(len(x)))
    blk = slice(pid * 2, pid * 2 + 2)
    bi, bm = torch.from_numpy(bi[:, blk]), torch.from_numpy(bm[:, blk])
    flagship = ModelConfig()
    ep = dp_kernel_epoch_for(flagship, TrainConfig(), mesh, dtype=torch.float32)
    st, losses = ep(state(flagship, inp["flagship"]), torch.from_numpy(x), torch.from_numpy(y),
                    bi, bm)
    out["kernel"] = {"losses": losses.numpy(), "params": _params(st)}

    mesh.close()
    torch.distributed.destroy_process_group()
    tmp = result_path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(out, fh)
    os.replace(tmp, result_path)


if __name__ == "__main__":
    main()
