"""Streaming tar-shard data pipeline (webdataset layout, no dependency).

Port of ``flash_diffusion_tpu/data/dataset.py:39-474``: shard list (brace
expansion) → shuffle → split by host → split by worker → tar → samples
grouped by file stem → decode → filters and mappers → shuffle buffer →
batches (one aspect bucket a batch with ``aspect_bucketing``). A shard is
a local path, a ``file://`` or ``http(s)://`` URL, or a
``pipe:`` command (``gs://`` and ``s3://`` through ``gsutil`` and ``aws``).
A corrupt member, shard or mapper input logs a warning and is skipped
(webdataset's ``warn_and_continue``). Workers are threads sharing one
bounded queue, or processes (``spawn``, ``fork`` when the mappers do not
pickle); the host split reads the ``torch.distributed`` rank when a process
group is up. ``prefetch_to_device`` overlaps the host pipeline with device
work: a thread stages each batch's arrays as pinned tensors.

As in JAX, the order is reproducible for a seed with one worker; with more,
the workers' samples interleave as they arrive.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import queue
import random
import re
import tarfile
import threading
import time
from dataclasses import field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..config import BaseConfig
from .collation import custom_collation_fn

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DataModuleConfig(BaseConfig):
    shards_path_or_urls: List[str] = field(default_factory=list)
    per_worker_batch_size: int = 4
    num_workers: int = 2
    worker_backend: str = "thread"  # thread | process
    shuffle_buffer_size: int = 100
    shuffle_shards: bool = True
    # pil: images decoded to PIL; raw: bytes for every member; raw_image:
    # JPEG members stay bytes (for ``native_decode.NativeDecodeMapper``),
    # other images decode to PIL, JSON and text as with pil
    decoder: str = "pil"  # pil | raw | raw_image
    seed: int = 0
    drop_last: bool = True
    # member-name rewrite of extensions before grouping (rename_files_fn)
    rename_files: Optional[Dict[str, str]] = None
    # JPEG draft decode: libjpeg decodes at the smallest DCT scale whose
    # result still covers (size, size); None decodes at full size
    decode_draft_size: Optional[int] = None
    # aspect-ratio bucketing (``data/bucketing.py``): with a
    # ``BucketAssignMapper`` in the chain, ``batches`` groups samples by
    # their ``__bucket__`` so that each batch has one (h, w)
    aspect_bucketing: bool = False


def _decode_member(name: str, data: bytes, decoder: str, draft_size: Optional[int] = None) -> Any:
    ext = name.rsplit(".", 1)[-1].lower()
    if decoder == "raw" or (decoder == "raw_image" and ext in ("jpg", "jpeg")):
        return data
    if ext in ("jpg", "jpeg", "png", "webp"):
        from PIL import Image

        img = Image.open(io.BytesIO(data))
        orig_hw = (img.height, img.width)  # the size before a draft decode
        if draft_size is not None and img.format == "JPEG":
            img.draft("RGB", (draft_size, draft_size))
        img = img.convert("RGB")
        img.info["original_size"] = orig_hw
        return img
    if ext == "json":
        return json.loads(data)
    if ext in ("txt", "text", "caption"):
        return data.decode("utf-8")
    if ext == "npy":
        return np.load(io.BytesIO(data), allow_pickle=False)
    if ext == "cls":
        return int(data)
    return data


def expand_shards(specs: Sequence[str]) -> List[str]:
    """Brace expansion as webdataset's: ``path/{00000..00042}.tar`` → 43
    zero-padded specs (several ranges expand recursively)."""
    out: List[str] = []
    for s in specs:
        m = re.search(r"\{(\d+)\.\.(\d+)\}", s)
        if not m:
            out.append(s)
            continue
        width = len(m.group(1))
        for i in range(int(m.group(1)), int(m.group(2)) + 1):
            out.extend(expand_shards([s[: m.start()] + str(i).zfill(width) + s[m.end():]]))
    return out


def _open_shard(spec: str):
    """A shard spec as a streaming byte source: (file object, closer)."""
    if spec.startswith("pipe:"):
        import shlex
        import subprocess

        proc = subprocess.Popen(shlex.split(spec[len("pipe:"):]), stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL)
        return proc.stdout, lambda: (proc.stdout.close(), proc.wait())
    if spec.startswith(("http://", "https://")):
        import urllib.request

        resp = urllib.request.urlopen(spec, timeout=60)
        return resp, resp.close
    if spec.startswith("gs://"):
        return _open_shard(f"pipe:gsutil cat {spec}")
    if spec.startswith("s3://"):
        return _open_shard(f"pipe:aws s3 cp {spec} -")
    if spec.startswith("file://"):
        spec = spec[len("file://"):]
    f = open(spec, "rb")
    return f, f.close


def iter_tar_samples(path: str, decoder: str = "pil", rename_files: Optional[Dict[str, str]] = None,
                     draft_size: Optional[int] = None) -> Iterator[Dict[str, Any]]:
    """Tar members grouped by file stem into samples keyed by extension
    (``000123.jpg`` + ``000123.json`` → one sample with ``jpg`` and
    ``json``, and ``__key__``). A shard that cannot be opened or read on,
    or a member that does not decode, is skipped with a warning."""
    closer = None
    try:
        fileobj, closer = _open_shard(path)
        tf = tarfile.open(fileobj=fileobj, mode="r|*")
    except Exception as e:  # warn and continue
        logger.warning("skipping shard %s: %s", path, e)
        if closer is not None:
            try:
                closer()
            except Exception:
                pass
        return
    current_key, sample = None, {}
    try:
        with tf:
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name
                if rename_files:
                    stem0, _, ext0 = name.partition(".")
                    if ext0 in rename_files:
                        name = f"{stem0}.{rename_files[ext0]}"
                if "." not in name:
                    continue
                stem, ext = name.split(".", 1)
                try:
                    value = _decode_member(name, tf.extractfile(member).read(), decoder, draft_size)
                except Exception as e:  # warn and continue
                    logger.warning("skipping member %s in %s: %s", name, path, e)
                    continue
                if stem != current_key:
                    if sample:
                        sample["__key__"] = current_key
                        yield sample
                    current_key, sample = stem, {}
                sample[ext.lower()] = value
        if sample:
            sample["__key__"] = current_key
            yield sample
    except Exception as e:  # a shard cut short: warn and continue
        logger.warning("stopping in shard %s: %s", path, e)
    finally:
        try:
            closer()
        except Exception:
            pass


def _queue_put(out_q, item, stop, timeout=0.2) -> bool:
    """A bounded put that gives up once the consumer has signalled stop."""
    while True:
        try:
            out_q.put(item, timeout=timeout)
            return True
        except queue.Full:
            if stop is not None and stop.is_set():
                return False


def _apply(filters_mappers, sample):
    for fm in filters_mappers:
        result = fm(sample)
        if result is False:
            return None
        if isinstance(result, dict):
            sample = result
    return sample


def _worker_loop(cfg, filters_mappers, shards, out_q, stop=None):
    """A worker: its shards → samples → filters and mappers → the queue;
    None when done. Module-level, so that it pickles for process workers."""
    for shard in shards:
        if stop is not None and stop.is_set():
            break
        for sample in iter_tar_samples(shard, cfg.decoder, cfg.rename_files, cfg.decode_draft_size):
            if stop is not None and stop.is_set():
                break
            try:
                mapped = _apply(filters_mappers, sample)
            except Exception as e:  # warn and continue
                logger.warning("mapper error on %s: %s", sample.get("__key__"), e)
                continue
            if mapped is not None and not _queue_put(out_q, mapped, stop):
                return
    _queue_put(out_q, None, stop)


def _host_rank():
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except Exception:
        pass
    return 0, 1


class DataPipeline:
    """The streaming pipeline over ``config.shards_path_or_urls``."""

    def __init__(self, config: DataModuleConfig, filters_mappers: Sequence[Callable] = (),
                 process_index: Optional[int] = None, process_count: Optional[int] = None):
        self.config = config
        self.filters_mappers = list(filters_mappers)
        if process_index is None:
            process_index, process_count = _host_rank()
        self.process_index, self.process_count = process_index, process_count or 1

    def _host_shards(self, epoch: int) -> List[str]:
        shards = expand_shards(self.config.shards_path_or_urls)
        if self.config.shuffle_shards:
            random.Random(self.config.seed + epoch).shuffle(shards)
        return shards[self.process_index::self.process_count]

    def samples(self, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        """Decoded, filtered, mapped samples through the shuffle buffer;
        worker i owns shards[i::n]. Workers stop (threads) or are
        terminated (processes) when the consumer abandons the iterator."""
        cfg = self.config
        shards = self._host_shards(epoch)
        if not shards:
            return
        n_workers = max(1, min(cfg.num_workers, len(shards)))
        splits = [shards[i::n_workers] for i in range(n_workers)]
        qsize = max(2 * cfg.per_worker_batch_size, 16)
        use_process = cfg.worker_backend == "process"
        stop = threading.Event()
        if use_process:
            import multiprocessing as mp
            import pickle

            try:
                pickle.dumps((cfg, self.filters_mappers))
                ctx = mp.get_context("spawn")
            except Exception:
                logger.warning("filters/mappers do not pickle; using fork() workers")
                ctx = mp.get_context("fork")
            out_q = ctx.Queue(maxsize=qsize)
            workers = [ctx.Process(target=_worker_loop, args=(cfg, self.filters_mappers, sp, out_q, None),
                                   daemon=True) for sp in splits]
        else:
            out_q = queue.Queue(maxsize=qsize)
            workers = [threading.Thread(target=_worker_loop, args=(cfg, self.filters_mappers, sp, out_q, stop),
                                        daemon=True) for sp in splits]
        for w in workers:
            w.start()
        try:
            rng = random.Random(cfg.seed + epoch + 1)
            buf: List[Dict[str, Any]] = []
            done = 0
            while done < n_workers:
                item = out_q.get()
                if item is None:
                    done += 1
                    continue
                if cfg.shuffle_buffer_size > 1:
                    buf.append(item)
                    if len(buf) >= cfg.shuffle_buffer_size:
                        yield buf.pop(rng.randrange(len(buf)))
                else:
                    yield item
            rng.shuffle(buf)
            yield from buf
        finally:
            stop.set()
            if use_process:
                for p in workers:
                    if p.is_alive():
                        p.terminate()
                for p in workers:
                    p.join(timeout=5)
                out_q.close()
                out_q.cancel_join_thread()
            else:
                while any(t.is_alive() for t in workers):  # a putter blocked on a full queue sees stop
                    try:
                        out_q.get(timeout=0.1)
                    except queue.Empty:
                        pass
                for t in workers:
                    t.join(timeout=5)

    def batches(self, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        cfg = self.config
        if cfg.aspect_bucketing:
            from .bucketing import bucket_batches

            yield from bucket_batches(self.samples(epoch), cfg.per_worker_batch_size, drop_last=cfg.drop_last)
            return
        batch: List[Dict[str, Any]] = []
        for sample in self.samples(epoch):
            batch.append(sample)
            if len(batch) == cfg.per_worker_batch_size:
                yield custom_collation_fn(batch)
                batch = []
        if batch and not cfg.drop_last:
            yield custom_collation_fn(batch)

    def __iter__(self):
        epoch = 0
        while True:
            yielded = False
            for b in self.batches(epoch):
                yielded = True
                yield b
            epoch += 1
            if not yielded:
                return


class DataModule:
    """A train and an optional eval pipeline."""

    def __init__(self, train_config: DataModuleConfig, train_filters_mappers: Sequence[Callable] = (),
                 eval_config: Optional[DataModuleConfig] = None, eval_filters_mappers: Sequence[Callable] = ()):
        self.train_pipeline = DataPipeline(train_config, train_filters_mappers)
        self.eval_pipeline = DataPipeline(eval_config, eval_filters_mappers) if eval_config else None

    def train_dataloader(self):
        return iter(self.train_pipeline)

    def eval_dataloader(self):
        return iter(self.eval_pipeline) if self.eval_pipeline else None


def _pinned(batch: Dict[str, Any], pin: bool) -> Dict[str, Any]:
    import torch

    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory() if pin else t
        else:
            out[k] = v
    return out


def prefetch_to_device(iterator, size: int = 2) -> Iterator[Dict[str, Any]]:
    """Batches of ``iterator`` read ahead by a thread (``size`` waiting), each
    array staged as a tensor, pinned when a CUDA device is there, so that
    the trainer's copy to the device does not wait on the host pipeline.
    The thread stops when the consumer abandons the iterator."""
    import torch

    pin = torch.cuda.is_available()
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def run():
        try:
            for item in iterator:
                if stop.is_set() or not _queue_put(q, _pinned(item, pin), stop):
                    return
            _queue_put(q, end, stop)
        except Exception as e:  # the consumer sees it
            _queue_put(q, e, stop)
        finally:
            if hasattr(iterator, "close"):  # a generator's own clean-up (its workers)
                iterator.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        deadline = time.monotonic() + 30.0
        while thread.is_alive() and time.monotonic() < deadline:
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
