"""One run of one cell: set-up, the measured window, the checks.

The program under test is ``imageprocessor_tpu_torch``: its workers
(the configuration's class, ``members`` of them in one consumer group)
with the broker, metadata store and object store the configuration's
environment names, built by the program's own factories with their files
under ``TMPDIR``, and the servers its ``services`` list run as child
processes. Nothing here imports the JAX package or the program's own
bench; the program is imported only inside :func:`run_cell`, after the
caller has looked for the card.

A run:

1. builds the program's kernel and host-codec libraries (hash-named
   caches under ``build/``: only a checkout's first run compiles);
2. sets the configuration's keys that the program's ``config.load`` does
   not read (the engine's switches) in this process's environment, and
   starts each of its services;
3. makes the cell's pools of originals from the seed and saves each once
   in the store, as the API would have;
4. builds the members and starts each on a thread; on a broker that is
   a server of its own each member has its own client, and the run waits
   until the group's round has settled with all of them in it;
5. warms the buckets and group sizes the traffic forms, with the
   traffic file's warm-up bursts;
6. hands over to the traffic's generator (``generators/<kind>.py``).
   ``setup_s`` runs from the process's start to the window's start.

After the window: the card's peak memory, then the checks against the
plain reference (``reference.py``) and the metrics' readers
(``metrics/<name>.py``). The look for JAX in ``sys.modules`` comes
last, in ``run.py``, once all of that has been imported.
"""

from __future__ import annotations

import concurrent.futures
import inspect
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
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
# brokers that are servers of their own: every member, and the harness,
# has a client of its own and so its own group membership
NETWORK_BROKERS = ("kafka",)
SERVICE_WAIT_S = 120.0   # a service's start until it accepts a connection
SERVICE_STOP_S = 30.0    # its SIGTERM until it has exited
GROUP_WAIT_S = 60.0      # the members' start until the group has settled


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


def config_keys() -> set[str]:
    """The environment variables the program's ``config.load`` reads: the
    quoted upper-case names in its source."""
    from imageprocessor_tpu_torch import config as ipconfig

    return set(re.findall(r'"([A-Z][A-Z0-9_]*)"', inspect.getsource(ipconfig.load)))


def free_port() -> int:
    """A loopback port that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
        self.services, self.members = spec.deployment(cfg)
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
        self.broker = None
        self.workers: list = []              # the members; worker is the first
        self.worker = None
        self.completed_by: dict[str, list[int]] = {}   # image id -> members
        self._children: dict[str, tuple[subprocess.Popen, int, object]] = {}
        self._saved_env: dict[str, str | None] = {}
        self._threads: list[threading.Thread] = []   # the members', then the listener
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
        self._set_switches()
        self._start_services()
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
        env.update(self._await_services())
        cfg = ipconfig.load(env)
        self.topic = cfg.broker.processing_topic
        self.results_topic = cfg.broker.results_topic
        self.meta = build_metadata_store(cfg.db)
        self.store = build_object_store(cfg.storage)
        self.broker = build_broker(cfg.broker)
        own_clients = cfg.broker.backend in NETWORK_BROKERS
        if own_clients:   # before any member joins
            for topic in (self.topic, self.results_topic):
                self.broker.create_topic(topic, cfg.broker.partitions)
        for originals in self.pools.values():
            for o in originals:
                o.path = self.store.save_original(
                    f"{o.kind}-{o.index}.jpg", o.jpeg, "image/jpeg")
        t0 = time.monotonic()
        module, cls = self.cfg["worker"].split(":")
        __import__(module)
        for _ in range(self.members):
            self.workers.append(getattr(sys.modules[module], cls)(
                cfg, meta=self.meta, store=self.store,
                broker=build_broker(cfg.broker) if own_clients else self.broker))
        self.worker = self.workers[0]
        self.extra["worker_s"] = time.monotonic() - t0
        if self.members > 1:
            self._count_completions()
        if self.on_worker is not None:
            self.on_worker(self)
        if self.trace:
            for w in self.workers:
                tracing.instrument(w.engine, self.spans)
        self._threads = [threading.Thread(target=w.run, name="worker" if k == 0 else f"worker{k}")
                         for k, w in enumerate(self.workers)]
        self._threads.append(threading.Thread(target=self._listen, name="results",
                                              args=(self._stop_listen,)))
        for t in self._threads:
            t.start()
        if own_clients:
            self._await_group(cfg.broker.group_id, cfg.broker.partitions)
        self.warm()

    def _set_switches(self) -> None:
        """The configuration's keys that ``config.load`` does not read, such
        as the engine's ``IMAGEPROCESSOR_*`` switches, go into this
        process's environment, where the program reads them (the engine
        once as it is built, the splice on every call), until ``close``."""
        env = self.cfg["env"]
        keys = sorted(set(env) - config_keys())
        self._saved_env = {k: os.environ.get(k) for k in keys}
        os.environ.update({k: str(env[k]) for k in keys})

    def _restore_env(self) -> None:
        for k, v in self._saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self._saved_env = {}

    def _start_services(self) -> None:
        """Each of the configuration's services (``spec.SERVICES``) as a
        child process, as a deployment runs its broker: not a thread of
        this interpreter. It gets a free loopback port, this run's
        environment with the configuration's ``env``, and no card."""
        for name in self.services:
            port = free_port()
            args = [a.format(port=port) for a in spec.SERVICES[name]["args"]]
            env = {**os.environ, **{k: str(v) for k, v in self.cfg["env"].items()},
                   "CUDA_VISIBLE_DEVICES": ""}
            log = open(os.path.join(self._tmp, f"{name}.log"), "wb")
            try:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "imageprocessor_tpu_torch.service", *args],
                    cwd=spec.repo_root(), env=env, stdin=subprocess.DEVNULL,
                    stdout=log, stderr=subprocess.STDOUT)
            except OSError:
                log.close()
                raise
            self._children[name] = (proc, port, log)

    def _await_services(self) -> dict[str, str]:
        """Waits until each service accepts a TCP connection. Returns the
        variables that point the members' ``Config`` at them."""
        out: dict[str, str] = {}
        for name, (proc, port, _log) in self._children.items():
            deadline = time.monotonic() + SERVICE_WAIT_S
            while True:
                try:
                    socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
                    break
                except OSError:
                    pass
                if proc.poll() is not None or time.monotonic() > deadline:
                    with open(os.path.join(self._tmp, f"{name}.log"), "rb") as f:
                        tail = f.read()[-2000:].decode(errors="replace")
                    raise RuntimeError(
                        f"service {name} did not accept a connection on port {port} "
                        f"within {SERVICE_WAIT_S} s (exit code {proc.poll()}): {tail}")
                time.sleep(0.05)
            out.update({k: v.format(port=port)
                        for k, v in spec.SERVICES[name]["env"].items()})
        return out

    def _stop_services(self) -> None:
        """SIGTERM each service and wait for it (a kill where it has not
        exited after ``SERVICE_STOP_S``); its exit code goes to
        ``extra["service_exit"]``."""
        for name, (proc, _port, log) in self._children.items():
            try:
                if proc.poll() is None:
                    proc.send_signal(signal.SIGTERM)
                    try:
                        proc.wait(SERVICE_STOP_S)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
            finally:
                log.close()
            self.extra.setdefault("service_exit", {})[name] = proc.returncode
        self._children = {}

    def _await_group(self, group: str, partitions: int) -> None:
        """Waits until every member holds its assignment from one round of
        the consumer group and every partition is owned, so that no
        rebalance falls in the warm-up or the window: a member that is
        mid-batch through a round is dropped and its batch redelivered.
        Reads each member's client's own view of its membership."""
        deadline = time.monotonic() + GROUP_WAIT_S
        while True:
            views = [w.broker._consumers.get((self.topic, group)) for w in self.workers]
            if all(c is not None and c.joined for c in views) \
                    and len({c.generation for c in views}) == 1 \
                    and sorted(p for c in views for p in c.partitions) == list(range(partitions)):
                self.extra["member_partitions"] = [sorted(c.partitions) for c in views]
                return
            if time.monotonic() > deadline:
                raise RuntimeError(f"the {self.members} members did not settle in group "
                                   f"{group} within {GROUP_WAIT_S} s")
            time.sleep(0.05)

    def _count_completions(self) -> None:
        """Which member completed each upload: a wrapper on each member's
        ``_finish_message``, the call that records, acks and answers one."""
        for k, w in enumerate(self.workers):
            def finish(msg, task, eng_res, k=k, real=w._finish_message):
                real(msg, task, eng_res)
                if eng_res.result.status.value == "completed":
                    with self.cond:
                        self.completed_by.setdefault(task.image_id, []).append(k)

            w._finish_message = finish

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
        """Stops every member, then the results listener."""
        for w in self.workers:
            w.stop()
        for t in self._threads[:-1]:
            t.join(WAIT_S)
        self._stop_listen.set()
        self._threads[-1].join(WAIT_S)
        if any(t.is_alive() for t in self._threads):
            raise RuntimeError("a worker or the results thread did not stop")

    def close(self) -> None:
        """Whatever set-up reached: stops and closes the members and the
        harness's own broker client, then the services, then restores the
        environment."""
        try:
            if any(t.is_alive() for t in self._threads):
                self.stop_worker()
            for w in self.workers:
                w.close()
            if self.broker is not None and all(w.broker is not self.broker
                                               for w in self.workers):
                self.broker.close()
        finally:
            try:
                self._stop_services()
            finally:
                self._restore_env()
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
        if self.members > 1:
            self.extra["member_completed"] = [
                sum(1 for i in self.judged if k in self.completed_by.get(i, ()))
                for k in range(self.members)]
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
    once the members are built, before they start."""
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
