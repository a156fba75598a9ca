"""Shot-enhancement service: watch a directory, enhance, persist, report
(the counterpart of ``specenh.serve``).

The deployment of the reference's workflow: new raw shots appear as SPEC
binaries from the digitizer pipeline; each goes through the resident
STFT -> conv-AE -> restitch service on the card (K1, then the AE stage
kernels, ``bench.harness.make_enhance_shot_fn``) and its spectrograms and
enhanced spectrograms are persisted with per-shot latency metrics.

One resident service (the kernels' weights prepared once), a directory
poller with a processed ledger (idempotent across restarts, as the
campaign manifest), quarantine for corrupt shots, and JSONL latency
metrics.  ``serve_once`` processes the current backlog and returns;
``serve_forever`` (the CLI's ``serve``) polls until interrupted or
``max_shots`` is reached.  The service runs on the card unless the caller
asks for the CPU.

Over a mesh (``EnhanceService(mesh=)``, one process a GPU), rank 0 is the
controller: it runs ``serve_once``/``serve_forever`` (the reader, the
manifest, the writers and the store) and, for each shot it dispatches,
broadcasts a header and the traces; every other rank runs ``follow()``,
which computes its block of channels and joins the gather of each shot,
until rank 0's stop (``close()``; ``serve_forever`` sends it when it
returns, ``serve_once`` when it raises).  While the watch directory is
empty, ``serve_forever`` broadcasts a keep-alive header at least every
``KEEPALIVE_S`` seconds, so a quiet period never lets the followers' wait
reach the collective timeout.  The collectives run on the dispatching
threads only, so every rank meets them in the same order; a corrupt shot
is quarantined on rank 0 and never dispatched.

A failure inside a shot's computation leaves the ranks in different
collectives, so no stop can reach the others: a rank that raises there
sends nothing more, and the ranks still in the shot fail at the
collective timeout (``SPECENH_DIST_TIMEOUT_S`` under the CLI).  The CLI's
launcher, and ``torchrun``, stop every rank as soon as one exits with an
error.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import os
import time
from typing import Optional

import numpy as np
import torch

from specenh_torch.bench.harness import make_enhance_shot_fn
from specenh_torch.config import Config, ModelConfig
from specenh_torch.io.native import read_shot
from specenh_torch.io.shots import shot_number_from_path
from specenh_torch.io.store import (
    CampaignManifest,
    SpectrogramStore,
    StoreWriterPool,
    retire_stale_manifest,
)
from specenh_torch.models.autoencoder import ConvAutoencoder, make_model
from specenh_torch.ops.stft import spectrogram_freqs, spectrogram_times
from specenh_torch.parallel.collectives import exchange_for
from specenh_torch.utils.logging import MetricsLogger, span

__all__ = ["EnhanceService", "serve_once", "serve_forever", "KEEPALIVE_S"]

KEEPALIVE_S = 1.0  # longest an idle mesh daemon's followers wait for a header

# the header's kinds: rank 0 stops the followers, sends a shot, or keeps them waiting
_STOP, _SHOT, _KEEPALIVE = 0, 1, 2


class EnhanceService:
    """Resident enhancement service: weights prepared once, serve many.

    ``params`` is a port ``ConvAutoencoder`` or its ``state_dict`` (None:
    glorot weights from a ``torch.Generator`` seeded 0, which are not the
    JAX package's ``PRNGKey(0)`` draw).  ``fn`` is the service
    (``make_enhance_shot_fn(model_cfg, cfg.spec, cfg.patch, dtype, device)``)
    and ``params`` what it serves: the kernels' weights where a kernel
    family covers ``model_cfg``, else the module.  A CUDA ``device``
    without a card raises.  ``mesh`` (a ``parallel.mesh.Mesh`` over
    "data", or an ``Exchange``, on ``device``'s type) shards the channels
    over its ranks: rank 0 serves (``dispatch``, ``serve_once``), the
    others ``follow()``; the service runs on the mesh's device."""

    def __init__(
        self,
        cfg: Config = Config(),
        model_cfg: ModelConfig = ModelConfig(),
        params=None,
        n_channels: int = 20,
        device="cuda",
        dtype=torch.bfloat16,
        mesh=None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("EnhanceService: no CUDA device (pass device='cpu' to serve "
                               "on the CPU)")
        self._ex = None if mesh is None else exchange_for(mesh)
        if self._ex is not None:
            if self._ex.device.type != self.device.type:
                raise ValueError(f"the mesh's device {self._ex.device} is not a "
                                 f"{self.device.type} device")
            self.device = self._ex.device
        self._stopped = False
        self._shots = 0  # dispatched so far: the key of each shot's spans
        self.cfg = cfg
        self.n_channels = n_channels
        self.fn = make_enhance_shot_fn(model_cfg, cfg.spec, cfg.patch, dtype=dtype,
                                       device=self.device, mesh=mesh, n_channels=n_channels)
        if isinstance(params, ConvAutoencoder):
            model = copy.deepcopy(params).to(self.device)  # the caller's module stays as it is
        else:
            model = make_model(model_cfg, generator=torch.Generator().manual_seed(0),
                               device=self.device)
            if params is not None:
                model.load_state_dict(params)
        # the kernels' weights built once: every call skips building them
        self.params = self.fn.prepare(model)
        self._f = spectrogram_freqs(cfg.spec)
        self._t = spectrogram_times(cfg.spec)

    @property
    def lead(self) -> bool:
        """Whether this process serves: no mesh, or rank 0 of it."""
        return self._ex is None or self._ex.rank == 0

    def _header(self, kind: int = _STOP, c: int = 0, t: int = 0) -> torch.Tensor:
        return torch.tensor([kind, c, t], dtype=torch.int64, device=self.device)

    def _check_lead(self) -> None:
        if not self.lead or self._stopped:
            raise RuntimeError("dispatch runs on rank 0 of a mesh service that is not closed")

    def dispatch(self, traces):
        """``fn`` on ``traces`` (C, n_samples): the full (specs, enhanced)
        on the device.  Over a mesh (rank 0 only) the shot's header and
        traces go to the other ranks' ``follow()`` first; if ``fn`` then
        raises, the service is closed without a stop (the followers are
        inside the shot's collectives: they fail at the collective
        timeout).  Recorded as the span ``serve.dispatch``, keyed by the
        count of shots dispatched before it."""
        with span("serve.dispatch", key=self._shots):
            self._shots += 1
            if self._ex is None:
                return self.fn(self.params, traces)
            self._check_lead()
            traces = torch.as_tensor(traces, dtype=torch.float32, device=self.device)
            self._ex.broadcast(self._header(_SHOT, *traces.shape))
            self._ex.broadcast(traces)
            try:
                return self.fn(self.params, traces)
            except BaseException:
                self._stopped = True
                raise

    def keepalive(self) -> None:
        """Over a mesh, on rank 0: a header the followers skip, which ends
        their wait before the collective timeout (nothing to do without a
        mesh)."""
        if self._ex is not None:
            self._check_lead()
            self._ex.broadcast(self._header(_KEEPALIVE))

    def follow(self) -> int:
        """The loop of a rank other than 0 of a mesh service: each shot
        rank 0 dispatches, its block computed and gathered, until rank 0's
        stop; returns the shots taken."""
        if self.lead:
            raise RuntimeError("follow() runs on the ranks other than 0 of a mesh service")
        n = 0
        while True:
            kind, c, t = self._ex.broadcast(self._header()).tolist()
            if kind == _STOP:
                return n
            if kind == _KEEPALIVE:
                continue
            traces = self._ex.broadcast(
                torch.empty((c, t), dtype=torch.float32, device=self.device))
            self.fn(self.params, traces)
            n += 1

    def close(self) -> None:
        """Over a mesh, on rank 0: stop the other ranks' ``follow()`` (once;
        nothing to do elsewhere, or after a shot failed on rank 0)."""
        if self._ex is not None and self.lead and not self._stopped:
            self._stopped = True
            self._ex.broadcast(self._header())

    def warmup(self):
        traces = np.zeros((self.n_channels, self.cfg.spec.n_samples), np.float32)
        _, enhanced = self.dispatch(traces)
        enhanced.ravel()[:1].cpu()

    def enhance(self, traces: np.ndarray):
        """(C, n_samples) -> (specs, enhanced) as numpy (host)."""
        specs, enhanced = self.dispatch(traces)
        return specs.cpu().numpy(), enhanced.cpu().numpy()


def _dispatched(service: EnhanceService, traces):
    """``service.dispatch`` on ``traces``, launched, and an event recorded
    after its work on the current CUDA stream (None on the CPU): the
    writer thread that copies the result waits on it, whichever stream it
    copies on."""
    result = service.dispatch(traces)
    if service.device.type != "cuda":
        return result, None
    done = torch.cuda.Event()
    done.record()
    return result, done


def serve_once(
    service: EnhanceService,
    watch_dir: str,
    store: SpectrogramStore,
    manifest: CampaignManifest,
    metrics: Optional[MetricsLogger] = None,
    max_new: Optional[int] = None,
    verbose: bool = True,
) -> dict:
    """Process the current backlog of *.bin shots (at most ``max_new``).

    Shots recorded done OR failed in the manifest are skipped: a corrupt
    shot is quarantined once across polls and restarts (delete its ledger
    line to force a retry).  Returns counts.

    Three stages on their own threads and queues: a READER thread reads
    shots from disk, the MAIN thread dispatches them to the device (the
    host->device copy, then the kernels launched; results in flight are
    bounded by the queues), and WRITER threads wait for a result, copy it
    to the host and persist it, so the read of shot i+1, the device work
    of shot i and the persist of shot i-1 overlap.  ``store`` is one
    ``SpectrogramStore`` (one writer thread) or a ``StoreWriterPool`` (a
    writer thread per shard file).  Each store is touched by one thread;
    the manifest, metrics and counts are serialized by a lock.

    Metrics per shot: ``read_s`` (disk) and ``latency_s`` (read start ->
    persisted, queueing included).  Per drain: a ``serve_batch`` event
    with shots/s.

    A mesh service serves on rank 0 (the other ranks run ``follow()``);
    an exception here stops their loops before it propagates."""
    if not service.lead:
        raise RuntimeError("serve_once runs on rank 0 of a mesh service; the other ranks "
                           "run follow()")
    try:
        return _serve_once(service, watch_dir, store, manifest, metrics, max_new, verbose)
    except BaseException:
        # the other ranks wait in follow() for rank 0's next header; where a
        # collective failed (a rank gone), the stop fails too
        with contextlib.suppress(RuntimeError):
            service.close()
        raise


def _serve_once(service, watch_dir, store, manifest, metrics, max_new, verbose) -> dict:
    import queue
    import threading

    todo = []
    for path in sorted(glob.glob(os.path.join(watch_dir, "*.bin"))):
        shot = shot_number_from_path(os.path.basename(path))
        if manifest.is_done(shot) or shot in manifest.failed_shots:
            continue
        todo.append((shot, path))
        if max_new is not None and len(todo) >= max_new:
            break
    counts = {"done": 0, "failed": 0}
    if not todo:
        return counts

    pool = (
        store if isinstance(store, StoreWriterPool)
        else StoreWriterPool.from_stores([store])
    )

    q_in: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()
    io_lock = threading.Lock()  # manifest + metrics + counts + prints

    def reader():
        for shot, path in todo:
            if stop.is_set():
                break
            t0 = time.perf_counter()
            try:
                traces = read_shot(
                    path, service.n_channels, service.cfg.spec.n_samples
                )
                q_in.put(("ok", shot, t0, time.perf_counter() - t0, traces))
            except Exception as e:  # corrupt shot -> quarantine downstream
                q_in.put(("err", shot, t0, time.perf_counter() - t0, e))
        q_in.put(None)

    def persist(own_store, item):
        kind, shot, t0, read_s, payload = item
        try:
            if kind == "err":
                with io_lock:
                    manifest.mark_failed(shot, str(payload))
                    counts["failed"] += 1
                    if verbose:
                        print(f"quarantined {shot}: {payload}")
                return
            (specs, enhanced), done = payload
            # device -> host copy HERE, off the dispatch thread
            if done is not None:
                done.synchronize()
            specs, enhanced = specs.cpu().numpy(), enhanced.cpu().numpy()
            for i in range(specs.shape[0]):
                own_store.write_channel(
                    shot, i + 1, specs[i], service._f, service._t,
                    enhanced[i], prefix="enhanced",
                )
            own_store.flush()
            latency = time.perf_counter() - t0
            with io_lock:
                manifest.mark_done(shot)
                counts["done"] += 1
                if metrics:
                    metrics.log(
                        "shot_enhanced", shot=shot,
                        channels=int(specs.shape[0]),
                        latency_s=latency, read_s=read_s,
                    )
                if verbose:
                    print(
                        f"shot {shot}: {specs.shape[0]} channels "
                        f"in {latency:.2f}s"
                    )
        except Exception as e:  # persist failure: quarantine, keep serving
            # if even RECORDING the failure fails (disk full), let it
            # escape: the pool's dead-writer drain keeps the pipeline
            # unblocked and join()/raise_if_failed reports it
            with io_lock:
                manifest.mark_failed(shot, f"persist: {e}")
                counts["failed"] += 1
                if verbose:
                    print(f"persist failed for {shot}: {e}")

    rt = threading.Thread(target=reader, name="serve-reader", daemon=True)
    rt.start()
    pool.start(persist)
    t_start = time.perf_counter()
    try:
        while True:
            item = q_in.get()
            if item is None:
                break
            kind, shot, t0, read_s, payload = item
            if kind == "err":
                pool.submit(shot, (kind, shot, t0, read_s, payload))
                continue
            result = _dispatched(service, payload)
            pool.submit(shot, ("ok", shot, t0, read_s, result))
    finally:
        # Shutdown MUST complete before serve_once returns or raises: the
        # caller's `with SpectrogramStore(...)` closes the h5py files the
        # writer threads use, so an exception (dispatch error,
        # KeyboardInterrupt) escaping with threads still live would have a
        # writer persisting into a closed store.  Finish the writers'
        # in-flight work, then unwedge and retire the reader.
        pool.join()
        stop.set()
        while rt.is_alive():  # drain q_in so a blocked reader put returns
            try:
                q_in.get_nowait()
            except queue.Empty:
                time.sleep(0.005)
        rt.join()
    pool.raise_if_failed()
    elapsed = time.perf_counter() - t_start
    if metrics:
        metrics.log(
            "serve_batch", done=counts["done"], failed=counts["failed"],
            seconds=elapsed, writers=pool.writers,
            shots_per_sec=(counts["done"] / elapsed) if elapsed > 0 else 0.0,
        )
    return counts


def _idle(service: EnhanceService, seconds: float) -> None:
    """Sleep ``seconds``; over a mesh, with a keep-alive at least every
    ``KEEPALIVE_S`` seconds."""
    end = time.monotonic() + seconds
    while True:
        service.keepalive()
        left = end - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, KEEPALIVE_S))


def serve_forever(
    service: EnhanceService,
    watch_dir: str,
    out_store: str,
    poll_s: float = 1.0,
    max_shots: Optional[int] = None,
    once: bool = False,
    writers: int = 1,
    verbose: bool = True,
) -> dict:
    """Poll ``watch_dir`` until ``max_shots`` NEW shots are processed (or
    forever).  ``once=True`` drains the current backlog and returns (for
    scripted runs); without it a restart against a fully processed
    directory keeps waiting for new shots (daemon semantics).

    ``writers > 1`` shards the persist stage over that many HDF5 writer
    threads and files (``StoreWriterPool``); readers see one union
    store.  A mesh service serves on rank 0, keeps the other ranks'
    ``follow()`` waiting between polls and stops it when this returns."""
    if not service.lead:
        raise RuntimeError("serve_forever runs on rank 0 of a mesh service; the other "
                           "ranks run follow()")
    store = (
        StoreWriterPool(out_store, writers)
        if writers > 1 else SpectrogramStore(out_store)
    )
    retire_stale_manifest(store, out_store + ".serve.jsonl")
    manifest = CampaignManifest(out_store + ".serve.jsonl")
    totals = {"done": 0, "failed": 0}
    try:
        with store, MetricsLogger(
            out_store + ".metrics.jsonl"
        ) as metrics:
            if not once:
                # daemon mode: pay the first call (the kernels' build and
                # load) before shots arrive; in drain mode the first shot
                # pays it
                service.warmup()
            while True:
                remaining = (
                    None if max_shots is None
                    else max_shots - totals["done"] - totals["failed"]
                )
                r = serve_once(
                    service, watch_dir, store, manifest, metrics,
                    max_new=remaining, verbose=verbose,
                )
                totals["done"] += r["done"]
                totals["failed"] += r["failed"]
                if once:
                    break
                if max_shots is not None and totals["done"] + totals["failed"] >= max_shots:
                    break
                _idle(service, poll_s)
    except KeyboardInterrupt:
        if verbose:
            print("interrupted; shutting down cleanly")
    finally:
        manifest.close()
        service.close()
    return totals
