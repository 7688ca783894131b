"""Streaming executor: overlapped device ISP, JPEG and host work
(counterpart of tpu_darktable/pipeline/streaming.py).

The serving runtime around the fused pipeline (BASELINE config 5: "full
fused ISP incl. JPEG, streaming batch").  PyTorch enqueues CUDA work without
waiting for it, so the host drains batch N's results while the card runs
batch N+1:

    feed (raw bytes) -> device fused ISP -> JPEG (device or host workers)

The reference has no streaming runtime (it loops synchronously per frame
with host syncs, image_processor.py:284-300).

Device-JPEG mode is double-buffered: each batch's JPEG device work
(orientation transform + DCT/quant + entropy packing) is enqueued right
after that batch's ISP - before the NEXT batch's ISP - and the host reads
batch N's compressed streams (PendingJpeg.result, which waits on an event
of that encode only) while batch N+1 computes.  Only the packed streams
cross to the host.  Host-JPEG mode reads each batch's frames back and
encodes them in worker threads with the host entropy scan (the native
packer releases the GIL).

A drainer thread drains the flushed batches in feed order, each as soon
as the card has finished it: it blocks on the batch's events (or its
readback) with the interpreter lock released, so it waits beside the
caller's thread, which may sit in the feed until the next frame is due.
`on_result` runs on the drainer, in feed order.  After flushing batch N
the caller waits until batch N-1 is drained before it takes the next
frame, so at most two batches' outputs are alive.  In a closed loop the
caller blocks there while the card finishes batch N-1, and each flush
starts before the batch ahead of it is drained; in an open loop batch N
is handed back while the caller waits for the next capture (counter
`stream.early_drains`: batches drained before the next flush began).
The drainer holds _graph's capture lock around each readback, so no
readback overlaps a CUDA graph capture on the caller's thread (a new
batch shape's first call).

Spans (utils/timing.py), each batch numbered in feed order (`seq`):
`stream.flush` (the batch's `stream.stack`, its process_batch and, in
device-JPEG mode, its `stream.jpeg_dispatch`) on the caller's thread, and
`stream.drain` on the drainer's, which starts once the batch is flushed
and the batch before it drained.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch

from .. import _graph
from ..utils import timing


@dataclass
class StreamResult:
    """One completed frame."""

    name: str
    image: np.ndarray | None = None     # uint8 (H, W, 3) unless jpeg-only
    jpeg: bytes | None = None
    error: Exception | None = None


@dataclass
class StreamingExecutor:
    """Pump frame batches through an ImageProcessor with overlapped stages.

    Args:
        processor: a pipeline.ImageProcessor (holds the fused pipeline + EMA).
        batch_size: frames per device batch.
        jpeg_quality: encode quality; None disables JPEG (images only).
        jpeg_workers: host JPEG encoder threads (host-entropy mode only).
        keep_images: include the uint8 frame in results (costs a frame
            readback; with device JPEG and keep_images=False only the
            compressed bytes cross to the host).
        device_jpeg: encode the entropy stream on the device (nvJPEG's
            fully-on-accelerator contract, jpeg_encoder.cu:117-173); else
            host worker threads run the host entropy scan.  None = auto: on
            when the processor's device is a card.
    """

    processor: object
    batch_size: int = 2
    jpeg_quality: int | None = 90
    jpeg_workers: int = 2
    keep_images: bool = True
    device_jpeg: bool | None = None
    _jpeg: object = field(default=None, repr=False)

    def __post_init__(self):
        if self.jpeg_quality is not None:
            from ..jpeg import Jpeg
            from ..ops.jpeg import _Stages

            self._jpeg = Jpeg()
            # the encoder's graphs allocate from the processor's pool: one
            # stream, and each replay clones its outputs before the next
            # graph runs, so FULL's working set and the JPEG stages' overlap
            self._jpeg._stages = _Stages(getattr(self.processor, '_graph_pool', None))
        if self.device_jpeg is None:
            self.device_jpeg = self.processor.device.type == 'cuda'

    def run(self, frames: Iterable[tuple[str, object]],
            on_result: Callable[[StreamResult], None] | None = None):
        """Process (name, raw_bytes_array) pairs; returns results in
        completion order.  Device work for batch i+1 overlaps the JPEG
        readback or encoding of batch i.  `on_result` is called on the
        drainer thread in feed order (host-JPEG mode: on the caller's
        thread once the feed has ended); what it raises comes out of run."""
        results: list[StreamResult] = []
        out_q: queue.Queue = queue.Queue()
        jpeg_q: queue.Queue = queue.Queue(maxsize=self.jpeg_workers * 4)
        device = self.processor.device

        def _jpeg_worker():
            while True:
                item = jpeg_q.get()
                if item is None:
                    return
                name, img = item
                try:
                    data = self._jpeg.encode(
                        np.ascontiguousarray(img), quality=self.jpeg_quality,
                        entropy='host', device=device,
                    )
                    out_q.put(StreamResult(
                        name=name,
                        image=img if self.keep_images else None,
                        jpeg=np.asarray(data).tobytes(),
                    ))
                except Exception as e:  # a frame's failure is its result
                    out_q.put(StreamResult(name=name, error=e))

        use_device_jpeg = self._jpeg is not None and self.device_jpeg
        workers = []
        if self._jpeg is not None and not use_device_jpeg:
            workers = [
                threading.Thread(target=_jpeg_worker, name='stream.jpeg', daemon=True)
                for _ in range(self.jpeg_workers)
            ]
            for t in workers:
                t.start()

        pending = 0
        flushed = 0
        batch_names: list[str] = []
        batch_bytes: list = []
        # the drainer's queue of flushed (seq, names, payload), None to stop
        to_drain: queue.Queue = queue.Queue()
        drained = threading.Condition()
        # under `drained`: the newest batch drained, whether the drainer has
        # stopped, and what stopped it
        drained_seq, stopped, error = -1, False, None

        def _resolve_transform(name):
            from .transform import ImageTransform

            tf = self.processor.transforms
            if isinstance(tf, dict):
                tf = tf.get(name, ImageTransform.none)
            return tf

        def _host_transform(img, name):
            """Orientation transform on the host (numpy); the same dispatch
            table as the device path (transform.transform)."""
            from .transform import transform

            return transform(img, _resolve_transform(name), xp=np)

        def _device_transform(img, name):
            """Orientation transform of a tensor on its device."""
            from .transform import transform

            return transform(img, _resolve_transform(name))

        def _dispatch_device_jpeg(names, out_dev):
            """Enqueue all of this batch's device work (transform + DCT +
            entropy packing) NOW, before the next batch's ISP is enqueued,
            so the card runs it back-to-back with the batch's ISP and the
            later .result() readbacks overlap the next batch's compute."""
            pend = []
            for i, name in enumerate(names):
                try:
                    img_dev = _device_transform(out_dev[i], name)
                    handle = self._jpeg.encode_async(
                        img_dev, quality=self.jpeg_quality)
                    pend.append((name, img_dev, handle, None))
                except Exception as e:  # a frame's failure is its result
                    pend.append((name, None, None, e))
            return pend

        def _drain(names, payload):
            nonlocal pending
            if use_device_jpeg:
                # Host side only: read back the compressed streams (and the
                # frame itself if keep_images).  All device work was already
                # enqueued at flush time.
                for name, img_dev, handle, err in payload:
                    try:
                        if err is not None:
                            raise err
                        with _graph._capture_lock:
                            r = StreamResult(
                                name=name,
                                image=img_dev.cpu().numpy()
                                if self.keep_images else None,
                                jpeg=handle.result().tobytes(),
                            )
                    except Exception as e:  # a frame's failure is its result
                        r = StreamResult(name=name, error=e)
                    results.append(r)
                    if on_result:
                        on_result(r)
                return
            with _graph._capture_lock:
                host = payload.cpu().numpy()  # waits for the batch
            for i, name in enumerate(names):
                img = np.ascontiguousarray(_host_transform(host[i], name))
                if self._jpeg is not None:
                    jpeg_q.put((name, img))
                    pending += 1
                else:
                    r = StreamResult(name=name, image=img)
                    results.append(r)
                    if on_result:
                        on_result(r)

        def _drainer():
            """Drain the flushed batches in feed order until told to stop."""
            nonlocal drained_seq, stopped, error
            try:
                while (batch := to_drain.get()) is not None:
                    seq, names, payload = batch
                    with timing.span('stream.drain', seq=seq):
                        _drain(names, payload)
                    # the batch's outputs go before the caller may flush another
                    del batch, names, payload
                    with drained:
                        drained_seq = seq
                        drained.notify_all()
            except Exception as e:  # re-raised by run on the caller's thread
                error = e
            finally:
                with drained:
                    stopped = True
                    drained.notify_all()

        def _wait_drained(seq):
            """Block until batch `seq` is drained; re-raise what stopped the
            drainer."""
            with drained:
                drained.wait_for(lambda: drained_seq >= seq or stopped)
            if error is not None:
                raise error

        def _flush_batch():
            nonlocal flushed
            if not batch_names:
                return
            seq, flushed = flushed, flushed + 1
            if seq and drained_seq >= seq - 1:
                timing.count('stream.early_drains')
            with timing.span('stream.flush', seq=seq):
                with timing.span('stream.stack'):
                    stacked = torch.stack([torch.as_tensor(b) for b in batch_bytes])
                out = self.processor.process_batch(stacked)
                if use_device_jpeg:
                    with timing.span('stream.jpeg_dispatch', seq=seq):
                        payload = _dispatch_device_jpeg(batch_names, out)
                else:
                    payload = out
            to_drain.put((seq, list(batch_names), payload))
            batch_names.clear()
            batch_bytes.clear()
            # at most two batches in flight: the device chews on this one
            # while the one before it drains
            _wait_drained(seq - 1)

        drainer = threading.Thread(target=_drainer, name='stream.drainer', daemon=True)
        drainer.start()
        try:
            for name, data in frames:
                batch_names.append(name)
                batch_bytes.append(data)
                if len(batch_names) == self.batch_size:
                    _flush_batch()
            _flush_batch()
            _wait_drained(flushed - 1)

            for _ in range(pending):
                r = out_q.get()
                results.append(r)
                if on_result:
                    on_result(r)
        finally:
            to_drain.put(None)
            drainer.join()
            for _ in workers:
                jpeg_q.put(None)
            for t in workers:
                t.join()
        return results


__all__ = ['StreamResult', 'StreamingExecutor']
