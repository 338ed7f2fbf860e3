"""The port's copies of the reference's jax-free modules stay equal to them.

imageprocessor_tpu_torch never imports the reference package, so it
carries copies of the domain types, the errors, the memory and SQLite
brokers, the local-filesystem and SQLite stores, the batcher, the host
codecs, the metrics, the config, the utils, the whole service layer
(usecase, handlers, app, both workers, the entry point, the client) and
the reference-topology backends (the Kafka wire codec, client and
server; the Postgres wire client and store; the S3 store).
Every top-level import, function, class and constant of a copy must have
the same source as the original's once the package name is swapped back
(a class is held method by method: ``Worker.run_once``); a copy may
leave out only the names listed in OMITTED and add only those in ADDED.
The service's static files are byte-equal.

The copies that differ do so in named places:

* runtime/codecs.py has no libjpeg shim (runtime/nativecodec.py): it
  imports the port's host library (runtime/hostcodec.py) in its place,
  and its decode_image and encode_image are held to the original's
  results instead — PNG, BMP and GIF exactly (both quantize GIFs with the
  same native Plan9 code); JPEG within 1 LSB on decode (two libjpeg
  builds may round the IDCT and the chroma upsample differently) and
  PSNR > 45 dB on encode (the same IJG quality tables; the encoders may
  round their FDCTs differently);
* runtime/splice.py imports runtime/hostcodec.py and the port's
  ops/watermark.py where the original imports nativecodec and the
  reference's ops/watermark.py; only its import lines may differ;
* runtime/coeftx.py imports the port's domain, splice and host library;
  its ``_rot_native`` differs only in the import line that binds the
  port's host library (whose csrc/coefrot.cpp is a copy of ipcodec.cpp's
  blocked rotation) as ``nativecodec``
  (test_coeftx_rot_native_differs_only_in_its_import;
  tests/test_torch_coeftx.py holds the results equal);
* broker/kafkawire.py: ``crc32c`` takes the port's host library
  (runtime/hostcodec.py, whose csrc/crc32c.cpp is a copy of ipcodec.cpp's
  ``ip_crc32c``) where the original takes nativecodec; only that import
  and the name it calls may differ
  (test_kafkawire_crc32c_differs_only_in_its_library);
* config.py: ``apply_device_platform`` returns the ``torch.device`` that
  DEVICE_PLATFORM names (empty means the card) where the original forces
  a JAX platform;
* utils/metrics.py: ``Metrics`` keeps a running sum of every timing
  beside its reservoir, and ``snapshot`` reports it as ``sum``
  (``__init__``, ``observe``, ``snapshot``, ``reset``): a time per item
  over a period is sum / count, which no percentile gives;
* service/worker.py: ``Worker.__init__`` resolves DEVICE_PLATFORM to a
  ``torch.device`` before any backend opens, refuses by name
  DEVICE_SPACE_AXIS above 1 and a DEVICE_DATA_AXIS above the local cards
  (or beside one named card), builds a TorchProcessingEngine with the
  data axis and has no compile cache (so the imports of the engine and of
  config differ too); ``run_once``, ``_parse_and_fetch`` and
  ``_finish_message`` put the broker's poll, the blob's fetch and the
  metadata writes with the ack and the results produce in ``poll``,
  ``fetch`` and ``record`` spans (utils/tracing.py, imported in ADDED),
  and inside ``record`` the ack or nack in an ``ack`` span and the
  results produce in a ``publish`` span; every other method is the
  original's;
* broker/kafka.py: ``KafkaBroker._join`` puts its whole JoinGroup /
  SyncGroup round in a ``group_join`` span (utils/tracing.py, imported
  inside the method: a process that only produces never loads torch) and
  counts each completed round in ``kafka_group_joins`` (utils/metrics.py,
  imported in ADDED), so that a rebalance inside a measured window shows;
  every other name is the original's;
* service/pipelined.py: ``run`` starts one device-stage thread per
  engine replica (the engine runs each group whole on one replica, where
  the original's splits every group across its chips), and
  ``_device_stage`` passes the stop sentinel on to the next of them, the
  last one stopping the finish stage; the engine's own ``decode``,
  ``device`` and ``encode`` spans replace the wrappers that
  ``_handle_message``, ``_device_stage`` and ``_finish_stage`` put
  around its calls, ``_handle_message`` passes the upload's id to the
  decode, and ``_decode_stage`` puts the broker's poll in a ``poll``
  span; stage 1 fetches and scans each polled message on a pool of
  WORKER_CONCURRENCY ``scan`` threads where the original runs
  ``_handle_message`` inline on its one decode thread: ``__init__`` makes
  the pool (``concurrent.futures``, imported in ADDED), ``_decode_stage``
  hands each message to it through ``_submit_scan`` (ADDED: at most
  2 x the pool's threads queued or running) and ``_scan`` (ADDED: the
  ``pipelined_scans`` counters, and a failure that escapes
  ``_handle_message`` completed), ``_drain`` nacks what was polled and
  never submitted and waits for every scan before the sentinel, and
  ``run`` shuts the pool down;
* service/__main__.py: ``main`` resolves the device through the config
  hook, and its ``worker`` mode runs the worker on a thread of its own
  while the main thread joins it: the original runs it on the main
  thread, where the SIGTERM handler's ``worker.stop()`` can deadlock on
  the stop Event the worker is waiting on
  (tests/test_torch_backends.py, ROADMAP §C).

utils/tracing.py is not a copy: it wraps torch.profiler where the
original wraps jax.profiler (tests/test_torch_config.py). Nor are the
engine and its host helpers (runtime/engine.py, runtime/hostcodec.py,
runtime/staging.py): they are the port's own, so the engine's card route
for baseline uploads (kernel B0) adds no name to ADDED or DIFFERS; its
renditions are held byte-equal to the host scan's route in
tests/test_torch_card_entropy.py, and that route to the reference's in
tests/test_torch_engine.py.
"""

import ast
import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image as PILImage

from imageprocessor_tpu.runtime import codecs as ref_codecs
from imageprocessor_tpu_torch.runtime import codecs as port_codecs
from tests.oracle import psnr

REPO = Path(__file__).resolve().parent.parent
REF, PORT = REPO / "imageprocessor_tpu", REPO / "imageprocessor_tpu_torch"

COPIES = ["domain/__init__.py", "domain/image.py", "domain/task.py", "errors.py",
          "broker/base.py", "broker/memory.py", "storage/object_store.py",
          "storage/localfs.py", "storage/metadata.py", "storage/sqlite_meta.py",
          "runtime/batcher.py", "runtime/codecs.py", "runtime/splice.py",
          "runtime/coeftx.py", "utils/metrics.py", "utils/__init__.py",
          "utils/logging.py", "utils/retrying.py", "utils/watchdog.py",
          "config.py", "broker/sqlitebroker.py", "service/__init__.py",
          "service/__main__.py", "service/usecase.py", "service/worker.py",
          "service/pipelined.py", "service/handlers.py", "service/app.py",
          "client.py", "broker/kafkawire.py", "broker/kafka.py",
          "broker/kafkaserver.py", "storage/pgwire.py",
          "storage/postgres_meta.py", "storage/s3.py"]
# names of the original a copy leaves out
OMITTED: dict[str, set[str]] = {}
# names a copy has that the original has not
ADDED = {"service/worker.py": {"from imageprocessor_tpu.utils.tracing"},
         "broker/kafka.py": {"from imageprocessor_tpu.utils.metrics"},
         "service/pipelined.py": {"from concurrent.futures",
                                  "PipelinedWorker._submit_scan",
                                  "PipelinedWorker._scan"}}
DIFFERS = {"runtime/codecs.py": {"from imageprocessor_tpu.runtime",
                                 "decode_image", "encode_image"},
           "runtime/coeftx.py": {"_rot_native"},
           "broker/kafkawire.py": {"crc32c"},
           "config.py": {"apply_device_platform"},
           "utils/metrics.py": {"Metrics.__init__", "Metrics.observe",
                                "Metrics.snapshot", "Metrics.reset"},
           "service/worker.py": {"from imageprocessor_tpu.config",
                                 "from imageprocessor_tpu.runtime.engine",
                                 "Worker.__init__", "Worker.run_once",
                                 "Worker._parse_and_fetch",
                                 "Worker._finish_message"},
           "service/pipelined.py": {"PipelinedWorker.__init__",
                                    "PipelinedWorker._drain",
                                    "PipelinedWorker._device_stage",
                                    "PipelinedWorker.run",
                                    "PipelinedWorker._decode_stage",
                                    "PipelinedWorker._handle_message",
                                    "PipelinedWorker._finish_stage"},
           "service/__main__.py": {"main"},
           "broker/kafka.py": {"KafkaBroker._join"}}
STATIC = ["index.html", "app.js", "style.css"]
# copies whose top-level imports are their own (the host library in place
# of nativecodec); every other top-level name keeps the original's source
OWN_IMPORTS = {"runtime/splice.py", "runtime/coeftx.py"}


def _top_level(path: Path, rename: bool) -> dict[str, str]:
    """Top-level imports, defs, classes and assignments -> their source."""
    src = path.read_text()
    if rename:
        src = src.replace("imageprocessor_tpu_torch", "imageprocessor_tpu")
    own_imports = path.relative_to(path.parents[1]).as_posix() in OWN_IMPORTS
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom):
            if own_imports and node.module != "__future__":
                continue
            names = [node.module]
        elif isinstance(node, ast.ClassDef):
            # a class is held method by method; what is left under the
            # class's own name is its header, docstring and attributes
            methods = [n for n in node.body
                       if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
            for m in methods:
                out[f"{node.name}.{m.name}"] = ast.unparse(m)
            node.body = [n for n in node.body if n not in methods] or [ast.Pass()]
            names = [node.name]
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign):
            names = [node.target.id]
        else:
            continue
        for name in names:
            key = f"from {name}" if isinstance(node, ast.ImportFrom) else name
            out[key] = ast.unparse(node)
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copy_has_the_originals_source(rel):
    port = _top_level(PORT / rel, rename=True)
    ref = _top_level(REF / rel, rename=False)
    assert port, rel
    assert set(ref) - set(port) == OMITTED.get(rel, set())
    assert set(port) - set(ref) == ADDED.get(rel, set())
    for name, src in port.items():
        if name in ADDED.get(rel, ()):
            continue
        assert name in ref, f"{rel}: {name} is not in the original"
        if name not in DIFFERS.get(rel, ()):
            assert src == ref[name], f"{rel}: {name} differs from the original"


def test_coeftx_rot_native_differs_only_in_its_import():
    port = _top_level(PORT / "runtime/coeftx.py", rename=True)["_rot_native"]
    ref = _top_level(REF / "runtime/coeftx.py", rename=False)["_rot_native"]
    swapped = "from imageprocessor_tpu.runtime import hostcodec as nativecodec"
    assert port.count(swapped) == 1
    assert port.replace(
        swapped, "from imageprocessor_tpu.runtime import nativecodec") == ref


def test_kafkawire_crc32c_differs_only_in_its_library():
    port = _top_level(PORT / "broker/kafkawire.py", rename=True)["crc32c"]
    ref = _top_level(REF / "broker/kafkawire.py", rename=False)["crc32c"]
    assert "hostcodec" in port and "nativecodec" not in port
    assert port.replace("hostcodec", "nativecodec") == ref


@pytest.mark.parametrize("name", STATIC)
def test_static_file_is_byte_equal(name):
    rel = f"service/static/{name}"
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes()
    assert sorted(p.name for p in (PORT / "service/static").iterdir()) \
        == sorted(p.name for p in (REF / "service/static").iterdir())


def _image(h, w, seed, alpha=False):
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 160, h)[:, None, None]
    xx = np.linspace(0, 80, w)[None, :, None]
    img = np.clip(yy + xx + rng.integers(0, 16, (h, w, 4 if alpha else 3)),
                  0, 255).astype(np.uint8)
    return img


def _blob(fmt, **save):
    bio = io.BytesIO()
    img = _image(97, 131, seed=len(fmt), alpha=fmt == "PNGA")
    PILImage.fromarray(img).save(bio, format=fmt[:3] if fmt == "PNGA" else fmt,
                                 **save)
    return bio.getvalue()


@pytest.mark.parametrize("fmt,save,lsb", [
    ("JPEG", {"quality": 90, "subsampling": 2}, 1),
    ("JPEG", {"quality": 90, "subsampling": 0}, 1),
    ("PNG", {}, 0), ("PNGA", {}, 0), ("GIF", {}, 0), ("BMP", {}, 0)])
def test_decode_image_matches_original(fmt, save, lsb):
    blob = _blob(fmt, **save)
    a, fa = ref_codecs.decode_image(blob)
    b, fb = port_codecs.decode_image(blob)
    assert fa == fb
    assert a.shape == b.shape
    assert np.abs(a.astype(int) - b.astype(int)).max() <= lsb


def test_truncated_jpeg_refused_alike():
    blob = _blob("JPEG", quality=90)[:600]
    with pytest.raises(ref_codecs.DecodeError):
        ref_codecs.decode_image(blob)
    with pytest.raises(port_codecs.DecodeError):
        port_codecs.decode_image(blob)


@pytest.mark.parametrize("fmt", ["jpeg", "png", "bmp", "gif"])
def test_encode_image_matches_original(fmt):
    img = _image(120, 161, seed=3)
    a, _ = ref_codecs.decode_image(ref_codecs.encode_image(img, fmt, 85))
    b, _ = ref_codecs.decode_image(port_codecs.encode_image(img, fmt, 85))
    assert a.shape == b.shape == img.shape
    if fmt == "jpeg":
        assert psnr(a, b) > 45.0
    else:
        np.testing.assert_array_equal(a, b)
