"""Subprocess worker of tests/test_torch_mesh_serve.py: one rank of a gloo
group on the CPU, running every sharded serving scenario the tests read.

Run as:  python tests/_torch_mesh_worker.py <coordinator> <num_procs> <pid> \\
             <inputs.pkl> <result.pkl>

Joins the group through ``specenh_torch.parallel.multihost
.initialize_distributed`` (a 50 s timeout on every collective, so a hang
fails the test instead of stopping the suite), then, in the same order on
every rank: the time-sharded long shot on a ``("time",)`` mesh, gathered
on rank 0; the channel-sharded service on a ``("data",)`` mesh over an
even and an uneven channel count; ``serve_once`` of a watch directory on
rank 0 while the other rank follows; and ``serve --devices 2 --device
cpu --once`` through the CLI, joining this group as a ``torchrun`` rank
does; then, on a group whose collectives time out after a few seconds,
an idle ``serve_forever`` that polls an empty directory for twice that
timeout before a shot arrives and is served, and a failure inside a
shot on rank 0.  Pickles rank 0's outputs (the others' must be None) for the parent
to hold against the single-process port.  Imports nothing of the JAX
package.
"""

import datetime
import os
import pickle
import sys
import threading
import time

import torch


def main() -> None:
    coordinator, n_procs, pid, inputs_path, result_path = sys.argv[1:6]
    n_procs, pid = int(n_procs), int(pid)
    torch.set_num_threads(1)

    from specenh_torch import cli as tcli
    from specenh_torch.bench.harness import make_enhance_shot_fn
    from specenh_torch.config import Config, ModelConfig, SpecParams
    from specenh_torch.io.binfmt import write_shot_bin
    from specenh_torch.io.store import CampaignManifest, SpectrogramStore
    from specenh_torch.models.autoencoder import make_model
    from specenh_torch.parallel import timeshard as ts
    from specenh_torch.parallel.mesh import Mesh, make_mesh
    from specenh_torch.parallel.multihost import initialize_distributed
    from specenh_torch.serve import EnhanceService, serve_forever, serve_once

    with open(inputs_path, "rb") as fh:
        inp = pickle.load(fh)
    initialize_distributed(coordinator, n_procs, pid, backend="gloo", timeout=50)
    tmesh = make_mesh(n_procs, ("time",), device="cpu")
    dmesh = make_mesh(n_procs, ("data",), device="cpu")
    model = make_model(ModelConfig(), generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(inp["flagship"])
    out = {"mesh": [tmesh.shape, dmesh.shape]}

    # the time-sharded shot: each rank's block of the trace, gathered on rank 0
    x, sp = inp["shot"]
    fn = ts.make_sharded_enhance_shot(ModelConfig(), sp, tmesh)
    local = fn(fn.prepare(model), ts.shard_of(tmesh, torch.from_numpy(x)))
    out["shot"] = ts.gather_shards(tmesh, *local)
    out["shot_local"] = [t.shape for t in local]

    # the channel-sharded service, full arrays on rank 0 only
    traces, sp_serve = inp["service"]
    out["service"] = {}
    for case, c, use_kernel in inp["service_cases"]:
        fn = make_enhance_shot_fn(ModelConfig(), sp_serve, device="cpu", use_kernel=use_kernel,
                                  mesh=dmesh, n_channels=c)
        out["service"][case] = fn(fn.prepare(model), traces[:c])

    # serve_once on rank 0, follow() on the others; then the CLI
    tiny = ModelConfig(filters=(4, 4), kernels=((3, 3), (3, 3)))
    service = EnhanceService(Config(spec=SpecParams(cut_shot=0.1)), tiny, inp["tiny"],
                             n_channels=2, device="cpu", mesh=dmesh)
    if service.lead:
        manifest = CampaignManifest(inp["out"] + ".serve.jsonl")
        with SpectrogramStore(inp["out"]) as store:
            out["counts"] = serve_once(service, inp["watch"], store, manifest, verbose=False)
        manifest.close()
        service.close()
    else:
        out["followed"] = service.follow()
    os.environ.update(RANK=str(pid), WORLD_SIZE=str(n_procs), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=coordinator.rsplit(":", 1)[1])
    tcli.main(["serve", "--watch-dir", inp["watch"], "--out", inp["cli_out"], "--channels", "2",
               "--cut-shot", "0.1", "--model", "scan_k3", "--devices", str(n_procs),
               "--device", "cpu", "--once", "--quiet"])

    # a quiet daemon outlives the collective timeout: the shot arrives after
    # twice the short group's timeout, written whole under its final name
    short = inp["short_timeout"]
    group = torch.distributed.new_group(backend="gloo",
                                        timeout=datetime.timedelta(seconds=short))
    smesh = Mesh(group, dmesh.rank, dmesh.size, ("data",), dmesh.device, "gloo")

    def late_shot():
        part = inp["late_path"] + ".part"
        write_shot_bin(part, inp["late"])
        os.replace(part, inp["late_path"])

    service = EnhanceService(Config(spec=SpecParams(cut_shot=0.1)), tiny, inp["tiny"],
                             n_channels=2, device="cpu", mesh=smesh)
    if service.lead:
        timer = threading.Timer(2 * short, late_shot)
        t0 = time.monotonic()
        timer.start()
        out["idle"] = serve_forever(service, os.path.dirname(inp["late_path"]),
                                    inp["idle_out"], poll_s=0.25, max_shots=1, verbose=False)
        out["idle_s"] = time.monotonic() - t0
        timer.join()
    else:
        out["idle_followed"] = service.follow()

    # a failure inside a shot on rank 0: it sends no stop (rank 1 is in the
    # shot's gather, which then fails at the timeout)
    service = EnhanceService(Config(spec=SpecParams(cut_shot=0.1)), tiny, inp["tiny"],
                             n_channels=2, device="cpu", mesh=smesh)
    if service.lead:
        def fail(*_):
            raise RuntimeError("injected")

        service.fn = fail
        try:
            service.dispatch(inp["late"])
        except RuntimeError as e:
            out["failed"] = str(e)
        t0 = time.monotonic()
        service.close()
        out["close_s"] = time.monotonic() - t0
    else:
        t0 = time.monotonic()
        try:
            service.follow()
        except RuntimeError:
            out["follow_failed_s"] = time.monotonic() - t0
    torch.distributed.barrier()

    torch.distributed.destroy_process_group()
    tmp = result_path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(out, fh)
    os.replace(tmp, result_path)


if __name__ == "__main__":
    main()
