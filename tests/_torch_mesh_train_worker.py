"""Subprocess worker of tests/test_torch_mesh_train.py: one rank of a gloo
group on the CPU, running every multi-rank training scenario the tests
read.

Run as:  python tests/_torch_mesh_train_worker.py <coordinator> <pid> \\
             <inputs.pkl> <result.pkl>

Joins a two-rank group through ``specenh_torch.parallel.multihost
.initialize_distributed`` (a 50 s timeout on every collective, so a hang
fails the test instead of stopping the suite) and runs, from the inputs'
weights and tiles: ``sweep_fit`` on a "sweep" mesh (2 configs; 3 configs
padded to 4, checkpointed and resumed; early stopping), ``sweep_fit_serial``
on a "data" mesh (the autograd engine, and the training kernels' plain
twins), ``fit_streaming(mesh=)`` (plain, from a tile cache with
checkpoints, resumed), ``train_from_raw(mesh=)`` and its uneven-channel
error, then the commands ``train --stream always``, ``train-raw`` and
``sweep`` (envelope) with ``--devices 2 --device cpu``, joined as
``torchrun`` would start them (each command ends the group; the next one
forms a new one on its own port).  Pickles each scenario's histories,
parameters and counts for the parent to hold against the JAX package and
the single-process port.  Imports nothing of the JAX package.
"""

import contextlib
import io
import os
import pickle
import sys

import torch


def _params(state) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.model.state_dict().items()}


def _sweep(res) -> dict:
    if res is None:
        return None
    return {"train": res.train_history, "val": res.val_history, "best": res.best_index,
            "n": len(res.configs),
            "stacked": {k: v.numpy().copy() for k, v in res.stacked_params.items()}}


def main() -> None:
    coordinator, pid, inputs_path, result_path = sys.argv[1:5]
    pid = int(pid)
    torch.set_num_threads(1)

    from specenh_torch import Config, ModelConfig, SpecParams, TrainConfig
    from specenh_torch import cli as tcli
    from specenh_torch import e2e
    from specenh_torch import sweep as tsweep
    from specenh_torch import train as T
    from specenh_torch import train_stream as ts
    from specenh_torch.config import PatchSpec
    from specenh_torch.data import tilecache
    from specenh_torch.io.store import SpectrogramStore
    from specenh_torch.parallel.mesh import make_mesh
    from specenh_torch.parallel.multihost import initialize_distributed

    with open(inputs_path, "rb") as fh:
        inp = pickle.load(fh)
    initialize_distributed(coordinator, 2, pid, backend="gloo", timeout=50)
    data = make_mesh(2, ("data",), device="cpu")
    sweep = make_mesh(2, ("sweep",), device="cpu")
    out = {}

    def cfgs(specs, shape=(64, 32, 1)):
        return [ModelConfig(filters=f, kernels=((k, k),) * len(f), out_kernel=(o, o),
                            input_shape=shape) for f, k, o in specs]

    def state(cfg, sd, tc=TrainConfig()):
        st = T.create_state(cfg, tc, device="cpu")
        st.model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        return st

    # the envelope on a "sweep" mesh: one config a rank; three padded to
    # four, checkpointed at epoch 1 and resumed to 2; lr 0 and patience 1
    x, y, xv, yv = inp["sweep"]
    pair = cfgs([((4, 4), 3, 3), ((8, 8), 5, 5)])
    three = cfgs([((4, 4), k, k) for k in (3, 5, 7)])
    tc = TrainConfig(batch_size=8, seed=0)
    out["sweep_pair"] = _sweep(tsweep.sweep_fit(pair, x, y, xv, yv, tc, epochs=3, mesh=sweep))
    out["sweep_pad"] = _sweep(tsweep.sweep_fit(three, x, y, xv, yv, tc, epochs=2, mesh=sweep))
    part = tsweep.sweep_fit(three, x, y, xv, yv, tc, epochs=1, mesh=sweep,
                            checkpoint_dir=inp["ck_sweep"])
    out["sweep_part"] = _sweep(part)
    out["sweep_resume"] = _sweep(tsweep.sweep_fit(three, x, y, xv, yv, tc, epochs=2, mesh=sweep,
                                                  checkpoint_dir=inp["ck_sweep"], resume=True))
    stop = TrainConfig(batch_size=8, seed=0, learning_rate=0.0, patience=1)
    out["sweep_stop"] = _sweep(tsweep.sweep_fit(pair, x, y, xv, yv, stop, epochs=6, mesh=sweep))

    # the serial engine on a "data" mesh: the module's autograd engine at the
    # small geometry, the training kernels' twins at the flagship's
    res = tsweep.sweep_fit_serial(pair, x, y, xv, yv, tc, epochs=2, mesh=data)
    out["serial"] = _sweep(res)
    kx, ky = inp["kernel"]
    res = tsweep.sweep_fit_serial([ModelConfig()], kx, ky, kx[:2], ky[:2],
                                  TrainConfig(batch_size=4, seed=0), epochs=1,
                                  dtype=torch.float32, mesh=data)
    out["serial_kernel"] = _sweep(res)

    # the streamed fit on a "data" mesh: plain; from a tile cache (counting
    # its builds), checkpointed, 2 epochs; resumed to 3; the cache budget
    ps = PatchSpec(tile_freq=32, tile_time=16, step=16, tiles_per_spec=5)
    tiny = ModelConfig(filters=(4, 4), kernels=((3, 3), (3, 3)), input_shape=(32, 16, 1))
    scfg = TrainConfig(epochs=3, seed=0, shuffle=True, batch_size=8)
    builds = []
    build = tilecache.build_tile_cache

    def counted_build(*a, **k):
        builds.append(a[3])
        return build(*a, **k)

    tilecache.build_tile_cache = counted_build
    with SpectrogramStore(inp["stream_store"], "r") as store:
        plan = ts.plan_stream_split(store, num_samples=3, ps=ps, cfg=scfg, seed=3)
        st, h = ts.fit_streaming(state(tiny, inp["tiny"], scfg), store, plan, scfg,
                                 chunk_tiles=8, ps=ps, mesh=data)
        out["stream"] = {"history": h, "params": _params(st)}
        st, h = ts.fit_streaming(state(tiny, inp["tiny"], scfg), store, plan, scfg, epochs=2,
                                 chunk_tiles=8, ps=ps, mesh=data, tile_cache=inp["tile_cache"],
                                 checkpoint_dir=inp["ck_stream"], metrics_path=inp["metrics"])
        out["stream_part"] = {"history": h, "params": _params(st), "builds": builds}
        st, h = ts.fit_streaming(state(tiny, inp["tiny"], scfg), store, plan, scfg,
                                 chunk_tiles=8, ps=ps, mesh=data,
                                 checkpoint_dir=inp["ck_stream"], resume=True)
        out["stream_resume"] = {"history": h, "params": _params(st)}
    out["budget"] = (ts._cache_budget("auto", data), ts._cache_budget("auto"),
                     ts._cache_budget("always", data))

    # raw traces to a model: each rank's two channels through the front,
    # all-gathered, dp_fit from the inputs' weights; three channels raise
    raw_cfg = ModelConfig(filters=(4, 4))
    create_state = e2e.create_state

    def from_inputs(mc, tcfg, **kw):
        st = create_state(mc, tcfg, **kw)
        st.model.load_state_dict({k: torch.from_numpy(v) for k, v in inp["raw_sd"].items()})
        return st

    e2e.create_state = from_inputs
    traces = inp["raw"]
    st, h = e2e.train_from_raw(traces, Config(spec=SpecParams(cut_shot=0.2)), raw_cfg,
                               TrainConfig(epochs=2, batch_size=4), mesh=data)
    out["raw"] = {"history": h, "params": _params(st)}
    try:
        e2e.train_from_raw(traces[:3], Config(spec=SpecParams(cut_shot=0.2)), raw_cfg,
                           TrainConfig(epochs=1, batch_size=4), mesh=data)
        out["raw_uneven"] = None
    except ValueError as e:
        out["raw_uneven"] = str(e)
    e2e.create_state = create_state

    # the commands, joined as torchrun starts them: the first joins this
    # group, and each ends the group it ran in
    os.environ.update(RANK=str(pid), LOCAL_RANK=str(pid), WORLD_SIZE="2",
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                      SPECENH_DIST_TIMEOUT_S="50")
    cli = inp["cli"]
    out["cli"] = {}
    for name, argv, port in (
            ("train", ["train", "--dataset", cli["store"], "--out-dir", cli["train"],
                       "--stream", "always", "--epochs", "2", "--num-shots", "2"], None),
            ("train-raw", ["train-raw", "--data-dir", cli["raw"], "--out-dir", cli["train_raw"],
                           "--channels", "2", "--cut-shot", "0.1", "--epochs", "1",
                           "--batch-size", "2"], cli["ports"][0]),
            ("sweep", ["sweep", "--dataset", cli["store"], "--out-dir", cli["sweep"],
                       *cli["grid"], "--epochs", "1", "--num-shots", "2"], cli["ports"][1])):
        if port is not None:
            os.environ["MASTER_PORT"] = str(port)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tcli.main([*argv, "--devices", "2", "--device", "cpu", "--quiet"])
        out["cli"][name] = buf.getvalue()
        assert not torch.distributed.is_initialized(), name

    tmp = result_path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(out, fh)
    os.replace(tmp, result_path)


if __name__ == "__main__":
    main()
