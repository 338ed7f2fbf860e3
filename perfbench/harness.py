"""One run of one cell: set-up, the measured window, the checks.

The program under test is ``imageprocessor_tpu_torch``: its worker
(the configuration's class) with the broker, metadata store and object
store the configuration's environment names, built by the program's own
factories with their files under ``TMPDIR``. Nothing here imports
the JAX package or the program's own bench; the program is imported only
inside :func:`run_cell`, after the caller has looked for the card.

A run:

1. builds the program's kernel and host-codec libraries (hash-named
   caches under ``build/``: only a checkout's first run compiles);
2. makes the cell's pools of originals from the seed and saves each once
   in the store, as the API would have;
3. builds the worker and starts it on a thread;
4. warms the buckets and group sizes the traffic forms, with the
   traffic file's warm-up bursts;
5. hands over to the traffic's generator (``generators/<kind>.py``).
   ``setup_s`` runs from the process's start to the window's start.

After the window: the card's peak memory, then the checks against the
plain reference (``reference.py``) and the metrics' readers
(``metrics/<name>.py``). The look for JAX in ``sys.modules`` comes
last, in ``run.py``, once all of that has been imported.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import shutil
import sys
import tempfile
import threading
import time
import uuid

import numpy as np
import torch

from perfbench import common, pool, reference, spec, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "imageprocessor_tpu")
RESULTS_GROUP = "perfbench-results"
WAIT_S = 300.0
LISTEN_IDLE_S = 0.02
# the checks of a sample's pixels against the reference (reference.py),
# each with its limit under the configuration's "limits"
PIXEL_CHECKS = ("gap_lsb", "tile_gap_lsb", "outside_band_px")
# where the backends that keep files keep them, under the run's directory
BACKEND_PATHS = {"METADATA_SQLITE_PATH": "metadata.db",
                 "BROKER_SQLITE_PATH": "broker.db",
                 "STORAGE_LOCALFS_ROOT": "objects"}


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``sys.modules`` that belong to JAX or to the
    JAX package, compared whole: ``imageprocessor_tpu_torch`` is not
    ``imageprocessor_tpu``."""
    tops = {name.split(".", 1)[0] for name in (modules if modules is not None
                                                else list(sys.modules))}
    return sorted(tops & set(FORBIDDEN))


def task_operations(flags: list[str]) -> list:
    """The operations the API makes of the upload's flags
    (handlers.parse_operations_from_form), as the program's types."""
    from imageprocessor_tpu_torch.domain import OperationParams, OperationType

    params = {"thumbnail": {"size": reference.THUMBNAIL_SIZE, "crop_to_fit": True},
              "resize": {"width": reference.RESIZE_W, "height": reference.RESIZE_H,
                         "keep_aspect": True},
              "watermark": {"text": reference.WATERMARK_TEXT,
                            "opacity": reference.WATERMARK_OPACITY,
                            "position": "bottom-right"}}
    return [OperationParams(OperationType(op), dict(params[op]))
            for op in reference.operations(flags)]


def tree_bytes(root: str) -> int:
    """Bytes of the files under ``root``: what a run left in its store
    and metadata, all written once (every object path is new)."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _dirs, files in os.walk(root) for f in files)


def process_start_monotonic() -> float:
    """This process's start on the monotonic clock (/proc, 10 ms)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.monotonic() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


class Run:
    """The state of one run that generators drive and readers read."""

    def __init__(self, name, cfg, traffic, seed, seconds, trace, device,
                 t_start, bench):
        self.name, self.cfg, self.traffic = name, cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.bench = bench
        self.pools: dict[str, list[pool.Original]] = {}
        self.spans = tracing.Spans()
        # image id -> [(monotonic time, status)] from the results topic
        self.results: dict[str, list[tuple[float, str]]] = {}
        self.requests: dict[str, tuple[pool.Original, list[str]]] = {}
        self.cond = threading.Condition()
        # set by the generator
        self.judged: list[str] = []          # the ids the window answers for
        self.setup_s = math.nan
        self.attempted = self.failed = 0
        self.latency_ms: list[float] = []    # open loop: one per request
        self.due: list[float] = []           # open loop: judged's due times
        self.lateness_ms: list[float] = []
        self.rate = math.nan
        self.extra: dict = {}                # earlier lines
        # trace
        self.trace_lo = self.trace_hi = 0.0  # wall clock
        self.device_events: list = []
        self.snapshot: dict = {}
        self.power_limit = ""
        self._prof = None
        self._tmp = ""
        self.worker = None
        self._threads: list[threading.Thread] = []
        self._stop_listen = threading.Event()
        self.on_worker = None                # run(run) once the worker is built

    # --- what generators call ------------------------------------------

    def submit(self, original: pool.Original, flags: list[str]) -> str:
        """What ImageUsecase.upload_image does once the original is
        saved: the metadata row, the task on the processing topic, the
        status set to processing. Returns the image id."""
        from imageprocessor_tpu_torch.domain import Image, ImageStatus, ProcessingTask

        image_id = str(uuid.uuid4())
        self.requests[image_id] = (original, flags)
        self.meta.save_image(Image(
            id=image_id, original_filename=f"{original.kind}-{original.index}.jpg",
            original_size=len(original.jpeg), mime_type="image/jpeg",
            status=ImageStatus.UPLOADED, original_path=original.path,
            bucket="images"))
        task = ProcessingTask(id=str(uuid.uuid4()), image_id=image_id,
                              original_path=original.path, bucket="images",
                              operations=task_operations(flags), format="jpeg")
        self.broker.produce(self.topic, image_id.encode(), task.to_json())
        self.meta.update_status(image_id, ImageStatus.PROCESSING)
        return image_id

    def wait_done(self, ids, deadline: float) -> bool:
        with self.cond:
            while not all(i in self.results for i in ids):
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.cond.wait(min(left, 0.5))
        return True

    def begin_window(self) -> float:
        """The end of set-up: starts the profiler on a traced run.
        Returns the window's start on the monotonic clock."""
        from imageprocessor_tpu_torch.utils.metrics import METRICS

        METRICS.reset()
        if self.trace:
            act = torch.profiler.ProfilerActivity
            self._prof = torch.profiler.profile(
                activities=[act.CUDA if self.device.type == "cuda" else act.CPU])
            self._prof.start()
            self.trace_lo = time.time()
        now = time.monotonic()
        self.setup_s = now - self.t_start
        return now

    def end_trace(self) -> None:
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.trace_hi = time.time()
        self._prof.stop()
        path = os.path.join(self._tmp, "trace.json")
        self._prof.export_chrome_trace(path)
        self.device_events = tracing.device_events(path)
        os.unlink(path)
        self._prof = None

    # --- set-up and tear-down ------------------------------------------

    def _listen(self, stop: threading.Event) -> None:
        """Reads the results topic through the broker's own poll and ack,
        whatever the backend. An answer's time is the broker's stamp of
        its produce (on the monotonic clock), else the time it is read."""
        from imageprocessor_tpu_torch.domain import ProcessingResult

        topic = self.results_topic
        while not stop.is_set():
            msgs = self.broker.poll(topic, RESULTS_GROUP, max_n=1024)
            now = time.monotonic()
            if not msgs:
                stop.wait(LISTEN_IDLE_S)
                continue
            wall_to_mono = time.monotonic() - time.time()
            with self.cond:
                for m in msgs:
                    res = ProcessingResult.from_json(m.value)
                    t = m.enqueued_at + wall_to_mono if m.enqueued_at > 0 else now
                    self.results.setdefault(res.image_id, []).append(
                        (min(t, now), res.status.value))
                self.cond.notify_all()
            for m in msgs:
                self.broker.ack(m)

    def setup(self) -> None:
        from imageprocessor_tpu_torch import config as ipconfig
        from imageprocessor_tpu_torch import kernels
        from imageprocessor_tpu_torch.broker import build_broker
        from imageprocessor_tpu_torch.runtime import hostcodec
        from imageprocessor_tpu_torch.storage import (
            build_metadata_store,
            build_object_store,
        )

        t0 = time.monotonic()
        hostcodec.library()
        if self.device.type == "cuda":
            kernels.library()
            self.power_limit = common.card_line()
        self.extra["build_s"] = time.monotonic() - t0

        self._tmp = tempfile.mkdtemp(prefix="perfbench-", dir=os.environ.get("TMPDIR"))
        t0 = time.monotonic()
        self.pools = pool.make_pools(self.traffic["pools"], self.seed, self.device)
        if self.device.type == "cuda":   # the peak is the program's, not the pool's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.extra["pool_s"] = time.monotonic() - t0
        self.extra["pool_bytes_per_px"] = {
            k: sum(len(o.jpeg) for o in v) / sum(o.h * o.w for o in v)
            for k, v in self.pools.items()}

        # the configuration's backends, by the program's own factories,
        # with every file of theirs under this run's directory
        env = {k: str(v) for k, v in self.cfg["env"].items()}
        env.update({k: os.path.join(self._tmp, f) for k, f in BACKEND_PATHS.items()})
        if self.device.type != "cuda":
            env["DEVICE_PLATFORM"] = "cpu"
        cfg = ipconfig.load(env)
        self.topic = cfg.broker.processing_topic
        self.results_topic = cfg.broker.results_topic
        self.meta = build_metadata_store(cfg.db)
        self.store = build_object_store(cfg.storage)
        self.broker = build_broker(cfg.broker)
        for originals in self.pools.values():
            for o in originals:
                o.path = self.store.save_original(
                    f"{o.kind}-{o.index}.jpg", o.jpeg, "image/jpeg")
        t0 = time.monotonic()
        module, cls = self.cfg["worker"].split(":")
        __import__(module)
        self.worker = getattr(sys.modules[module], cls)(
            cfg, meta=self.meta, store=self.store, broker=self.broker)
        self.extra["worker_s"] = time.monotonic() - t0
        if self.on_worker is not None:
            self.on_worker(self)
        if self.trace:
            tracing.instrument(self.worker.engine, self.spans)
        self._threads = [threading.Thread(target=self.worker.run, name="worker"),
                         threading.Thread(target=self._listen, name="results",
                                          args=(self._stop_listen,))]
        for t in self._threads:
            t.start()
        self.warm()

    def warm(self) -> None:
        """The traffic file's bursts ([pool, n, flags]): n uploads at once,
        each burst drained before the next; not judged, not timed."""
        t0 = time.monotonic()
        for kind, n, flags in self.traffic["warm"]:
            originals = self.pools[kind]
            ids = [self.submit(originals[i % len(originals)], flags) for i in range(n)]
            if not self.wait_done(ids, time.monotonic() + WAIT_S):
                raise RuntimeError(f"warm-up burst of {n} {kind} did not complete")
        self.spans.items.clear()
        self.extra["warm_s"] = time.monotonic() - t0

    def stop_worker(self) -> None:
        self.worker.stop()
        self._threads[0].join(WAIT_S)
        self._stop_listen.set()
        self._threads[1].join(WAIT_S)
        if any(t.is_alive() for t in self._threads):
            raise RuntimeError("the worker or the results thread did not stop")

    def close(self) -> None:
        if self.worker is not None:
            if any(t.is_alive() for t in self._threads):
                self.stop_worker()
            self.worker.close()
        if self._tmp:
            shutil.rmtree(self._tmp, ignore_errors=True)

    # --- the checks ----------------------------------------------------

    def check(self) -> dict:
        """Each judged upload has exactly one result, `completed`, a
        `completed` metadata row and every variant stored with the dims
        the reference gives; a sample drawn from the seed, one upload of
        every original first, is held to the reference pixel by pixel
        (``PIXEL_CHECKS``). Returns {check: (value, limit)}."""
        from imageprocessor_tpu_torch.domain import ImageStatus
        from imageprocessor_tpu_torch.storage.object_store import ObjectNotFound

        limits = self.cfg["limits"]
        bad_records = bad_objects = 0
        for image_id in self.judged:
            original, flags = self.requests[image_id]
            got = self.results.get(image_id, [])
            if len(got) != 1 or got[0][1] != "completed" or \
                    self.meta.get_image(image_id).status is not ImageStatus.COMPLETED:
                bad_records += 1
                continue
            rows = {p.operation: p.path for p in self.meta.list_processed(image_id)}
            ops = reference.operations(flags)
            if sorted(rows) != sorted(ops):
                bad_objects += 1
                continue
            for op in ops:
                try:
                    dims = reference.jpeg_dims(self.store.get_object(rows[op]))
                except ObjectNotFound:
                    dims = None
                if dims != reference.expected_dims(op, original.h, original.w):
                    bad_objects += 1
                    break
        sample = self.sample()
        judged = self.judge(sample).values()
        self.extra["sampled"] = len(sample)
        out = {"incomplete_uploads": (bad_records, 0), "bad_variants": (bad_objects, 0)}
        for name in PIXEL_CHECKS:
            out[name] = (max((j[name] for j in judged), default=0.0), limits[name])
        return out

    def sample(self) -> list[str]:
        ok = [i for i in self.judged
              if [s for _t, s in self.results.get(i, [])] == ["completed"]]
        rng = np.random.default_rng(self.seed)
        order = [ok[k] for k in rng.permutation(len(ok))]
        first, seen = [], set()
        for i in order:   # one upload of every original first
            key = (self.requests[i][0].kind, self.requests[i][0].index)
            if key not in seen:
                seen.add(key)
                first.append(i)
        firsts = set(first)
        rest = [i for i in order if i not in firsts]
        return (first + rest)[:max(int(self.traffic["sample"]), len(first))]

    def judge(self, sample: list[str]) -> dict[str, dict[str, float]]:
        """{image id: {check: its worst reading over the upload's
        variants}} for the pixel checks (``PIXEL_CHECKS``)."""
        from imageprocessor_tpu_torch.storage.object_store import ObjectNotFound

        font = os.environ["IMAGEPROCESSOR_FONT"]
        q = int(self.cfg["jpeg_quality"])
        keys = sorted({(self.requests[i][0].kind, self.requests[i][0].index,
                        tuple(reference.operations(self.requests[i][1])))
                       for i in sample})

        def expect(key):
            kind, idx, ops = key
            r = reference.renditions(self.pools[kind][idx].jpeg, list(ops), font)
            return key, {op: (x, reference.stored_view(x, q)) for op, x in r.items()}

        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            ref = dict(ex.map(expect, keys))

        def one(image_id):
            original, flags = self.requests[image_id]
            ops = reference.operations(flags)
            rows = {p.operation: p.path for p in self.meta.list_processed(image_id)}
            worst = dict.fromkeys(PIXEL_CHECKS, 0.0)
            for op, (x, view) in ref[(original.kind, original.index, tuple(ops))].items():
                try:
                    stored = reference.decode(self.store.get_object(rows[op]))
                except (KeyError, ObjectNotFound, ValueError):
                    return image_id, dict.fromkeys(PIXEL_CHECKS, math.inf)
                got = {"gap_lsb": reference.gap_lsb(stored, x, view),
                       "tile_gap_lsb": reference.tile_gap_lsb(stored, x, view),
                       "outside_band_px": reference.outside_band_px(stored, x)}
                worst = {k: max(worst[k], got[k]) for k in PIXEL_CHECKS}
            return image_id, worst

        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            return dict(ex.map(one, sample))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             traffic_overrides: dict | None = None, bench: dict | None = None,
             on_worker=None) -> tuple[dict, Run]:
    """One run of the workload ``name``. Returns (the result line as a
    dict, the Run). ``on_worker(run)``, for tests and the control, runs
    once the worker is built, before its warm-up."""
    bench = bench or spec.load_benchmark()
    cell = spec.workload(bench, name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell)
    traffic.update(traffic_overrides or {})
    run = Run(name, cfg, traffic, seed, seconds, trace, device,
              t_start if t_start is not None else time.monotonic(), bench)
    run.on_worker = on_worker
    run.extra["start_to_harness_s"] = time.monotonic() - run.t_start
    os.environ["IMAGEPROCESSOR_FONT"] = common.ensure_font()
    try:
        run.setup()
        spec.generator(traffic["kind"]).drive(run)
        run.stop_worker()
        peak = (torch.cuda.max_memory_allocated(run.device)
                if run.device.type == "cuda" else 0)
        from imageprocessor_tpu_torch.utils.metrics import METRICS

        run.snapshot = METRICS.snapshot()
        checks = run.check()
        run.extra["written_bytes"] = tree_bytes(run._tmp)
    finally:
        run.close()
    line = result_line(run, checks, peak)
    return line, run


def result_line(run: Run, checks: dict, peak: int) -> dict:
    kind = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in spec.cell_metrics(run.bench, run.name, kind):
        value = spec.metric(m["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": dev}
    if run.trace:
        lo, hi = run.trace_lo, run.trace_hi
        dev["busy_s"] = tracing.busy_seconds(
            [(a, b) for _n, _c, a, b in run.device_events], lo, hi)
        dev["window_s"] = hi - lo
        line["breakdown"] = breakdown(run)
        # the trace's clock against the spans': the card's busy time that
        # falls inside device_group calls, which launch all of it
        ev = [(a, b) for _n, _c, a, b in run.device_events]
        inside = sum(tracing.busy_seconds(ev, a, b) for a, b in tracing.union(
            (s.t0, s.t1) for s in run.spans.of("device_group")))
        run.extra["busy_in_device_group"] = inside / dev["busy_s"] if dev["busy_s"] else None
    # JSON has no infinity: a check that read none (dims that differ, an
    # upload never answered) prints null, and is not correct
    line["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def breakdown(run: Run) -> dict:
    lo, hi = run.trace_lo, run.trace_hi
    by_name: dict[str, float] = {}
    for name, _cat, a, b in run.device_events:
        by_name[name] = by_name.get(name, 0.0) + (min(b, hi) - max(a, lo))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spans = run.spans.items
    gaps = tracing.idle_gaps([(a, b) for _n, _c, a, b in run.device_events], lo, hi)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[tracing.label(g, spans), g[1] - g[0]] for g in gaps]}


def describe(run: Run) -> str:
    """The lines before the result: the run's other numbers."""
    out = {"workload": run.name, "seed": run.seed, "setup_s": run.setup_s,
           "card": run.power_limit, **run.extra}
    if run.snapshot:
        out["timings"] = run.snapshot.get("timings", {})
        out["counters"] = run.snapshot.get("counters", {})
    return json.dumps(out, default=str)
