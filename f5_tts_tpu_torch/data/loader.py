"""Host-side streaming data pipeline (the port of the JAX package's
`data/loader.py`): a composable sample stream with threaded decode, a
shuffle buffer, padded batching to frame buckets and a prefetch thread,
yielding the batches the trainers consume ({"mel_spec" or "audio",
"mel_len", "transcript"}).

The host mel (`collate_audio_batch`) runs the port's `log_mel_spectrogram`
on a CPU tensor, as the reference pins its mel to the CPU backend; with
`on_device_mel=True` the batches carry raw audio and the trainer computes
the mel on the card inside the step. No stage touches CUDA: grad mode and
the current device are per thread, and these run in worker threads.
"""

from __future__ import annotations

import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

import numpy as np

SAMPLE_RATE = 24_000
HOP_LENGTH = 256

# byte-level vocab of the LibriTTS example scripts
BYTE_VOCAB = {chr(i): i for i in range(256)}


class Stream:
    """A restartable, composable sample stream."""

    def __init__(self, factory: Callable[[], Iterable]):
        self._factory = factory

    def __iter__(self) -> Iterator:
        return iter(self._factory())

    @classmethod
    def from_list(cls, items: list) -> "Stream":
        return cls(lambda: iter(items))

    def repeat(self, n: int) -> "Stream":
        def gen():
            for _ in range(n):
                yield from self._factory()

        return Stream(gen)

    def shuffle(self, buffer_size: int, seed: int | None = None) -> "Stream":
        """Reservoir-style shuffle buffer on `random.Random(seed)`, drawing
        exactly as the JAX package's, so a seed gives its order."""

        def gen():
            rng = random.Random(seed)
            buf: list = []
            for item in self._factory():
                buf.append(item)
                if len(buf) >= buffer_size:
                    idx = rng.randrange(len(buf))
                    buf[idx], buf[-1] = buf[-1], buf[idx]
                    yield buf.pop()
            rng.shuffle(buf)
            yield from buf

        return Stream(gen)

    def filter(self, pred: Callable) -> "Stream":
        return Stream(lambda: (x for x in self._factory() if pred(x)))

    def map(self, fn: Callable, num_threads: int = 1) -> "Stream":
        """Apply fn to each sample; with num_threads > 1, an ordered
        thread-pool map (the decode stage). fn returning None drops a sample."""
        if num_threads <= 1:
            def gen():
                for x in self._factory():
                    y = fn(x)
                    if y is not None:
                        yield y

            return Stream(gen)

        def gen():
            # a bounded in-flight window: ThreadPoolExecutor.map would submit
            # the whole upstream at once and hold every decoded clip of a
            # multi-epoch run ahead of the consumer
            window = num_threads * 2
            pool = ThreadPoolExecutor(num_threads)
            pending: deque = deque()
            try:
                for item in self._factory():
                    pending.append(pool.submit(fn, item))
                    if len(pending) >= window:
                        y = pending.popleft().result()
                        if y is not None:
                            yield y
                # drain on exhaustion only, never in `finally`: a consumer that
                # closes the stream early (the trainer's break at total_steps)
                # would get "generator ignored GeneratorExit"
                while pending:
                    y = pending.popleft().result()
                    if y is not None:
                        yield y
            finally:
                # on an early close the queued decodes are cancelled and the
                # running ones finish before close() returns
                pool.shutdown(wait=True, cancel_futures=True)

        return Stream(gen)

    def batch(
        self, batch_size: int, collate: Callable[[list], dict], drop_remainder: bool = False
    ) -> "Stream":
        """drop_remainder=True keeps every batch exactly batch_size."""

        def gen():
            buf: list = []
            for item in self._factory():
                buf.append(item)
                if len(buf) == batch_size:
                    yield collate(buf)
                    buf = []
            if buf and not drop_remainder:
                yield collate(buf)

        return Stream(gen)

    def dynamic_batch(
        self,
        buffer_size: int,
        max_frames: int,
        collate: Callable[[list], dict],
        length_fn: Callable = None,
        seed: int | None = None,
    ) -> "Stream":
        """Duration-aware batching: fill a buffer, sort it by length, and cut
        batches whose padded cost (longest item x batch size) stays within
        `max_frames`; the batches of a buffer come out in a seeded shuffle."""
        if length_fn is None:
            length_fn = lambda s: s["audio"].shape[0] // HOP_LENGTH

        def gen():
            rng = random.Random(seed)

            def emit(buf):
                buf.sort(key=length_fn)
                batches = []
                cur: list = []
                for item in buf:
                    cost = (len(cur) + 1) * length_fn(item)  # sorted: the last is the longest
                    if cur and cost > max_frames:
                        batches.append(cur)
                        cur = []
                    cur.append(item)
                if cur:
                    batches.append(cur)
                rng.shuffle(batches)
                for b in batches:
                    yield collate(b)

            buf: list = []
            for item in self._factory():
                buf.append(item)
                if len(buf) >= buffer_size:
                    yield from emit(buf)
                    buf = []
            if buf:
                yield from emit(buf)

        return Stream(gen)

    def shard(self, global_batch: int, sl: slice) -> "Stream":
        """Keep only the items in `sl` of every complete `global_batch`-item
        window: this process's slice of each global batch
        (parallel/distributed.process_local_batch_slice). Applied before
        decode, so each process decodes only its own items; the upstream
        must be the same on every process (a seeded shuffle of the same file
        list). A partial last window is dropped on every process: emitting
        it would give the processes unequal step counts and deadlock the
        training collectives."""

        def gen():
            win: list = []
            for item in self._factory():
                win.append(item)
                if len(win) == global_batch:
                    yield from win[sl]
                    win = []

        return Stream(gen)

    def prefetch(self, prefetch_size: int = 2) -> "Stream":
        """A background thread filling a queue of `prefetch_size` items; an
        error upstream is raised in the consumer. When the consumer closes
        the stream early, the thread stops at its next put and closes the
        upstream (which shuts a threaded map's pool down) before close()
        returns."""

        def gen():
            q: queue.Queue = queue.Queue(maxsize=prefetch_size)
            sentinel = object()
            error: list[BaseException] = []
            stop = threading.Event()

            def put(item) -> bool:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.05)
                        return True
                    except queue.Full:
                        pass
                return False

            def worker():
                it = iter(self._factory())
                try:
                    for item in it:
                        if not put(item):
                            break
                except BaseException as e:  # propagate into the consumer
                    error.append(e)
                finally:
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()
                    put(sentinel)

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is sentinel:
                        if error:
                            raise error[0]
                        return
                    yield item
            finally:
                stop.set()
                t.join()

        return Stream(gen)


# -------------------------------------------------------------- collation


def pad_to_multiple(x: np.ndarray, axis: int, multiple: int, value=0.0) -> np.ndarray:
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - size)
    return np.pad(x, pad, constant_values=value)


def _bucket_audio(samples: list[dict], pad_frame_multiple: int) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad a batch's raw audio to the frame-bucket boundary before any
    mel, so the steps see one shape per bucket; returns (audio [b,
    frames * HOP_LENGTH], mel lengths [b])."""
    mel_lens = np.array([s["audio"].shape[0] // HOP_LENGTH for s in samples], dtype=np.int32)
    max_frames = -(-int(mel_lens.max()) // pad_frame_multiple) * pad_frame_multiple
    max_samples = max_frames * HOP_LENGTH

    audio = np.zeros((len(samples), max_samples), dtype=np.float32)
    for i, s in enumerate(samples):
        n = min(s["audio"].shape[0], max_samples)
        audio[i, :n] = s["audio"][:n]
    return audio, mel_lens


def _collate_transcripts(samples: list[dict]) -> np.ndarray:
    nt = max(s["transcript"].shape[0] for s in samples)
    transcript = np.full((len(samples), nt), -1, dtype=np.int32)
    for i, s in enumerate(samples):
        transcript[i, : s["transcript"].shape[0]] = s["transcript"]
    return transcript


def collate_audio_batch(samples: list[dict], pad_frame_multiple: int = 256) -> dict:
    """samples: [{"audio": float32 [nw], "transcript": int32 [nt]}] ->
    {"mel_spec" [b, n, d], "mel_len" [b], "transcript" [b, nt]}: the mel of
    the bucketed audio, computed on the CPU, with frames past each item's
    length set to 0.0 (the batch pad value, not the log floor)."""
    import torch

    from f5_tts_tpu_torch.audio.mel import log_mel_spectrogram

    audio, mel_lens = _bucket_audio(samples, pad_frame_multiple)
    mel = log_mel_spectrogram(torch.from_numpy(audio)).numpy()

    n = mel.shape[1]
    if n % pad_frame_multiple:
        raise AssertionError(f"the bucketed mel has {n} frames, not a multiple of {pad_frame_multiple}")
    frame_idx = np.arange(n)[None, :]
    mel = np.where((frame_idx < mel_lens[:, None])[..., None], mel, 0.0)

    return {"mel_spec": mel, "mel_len": mel_lens, "transcript": _collate_transcripts(samples)}


def collate_raw_audio_batch(samples: list[dict], pad_frame_multiple: int = 256) -> dict:
    """Raw-audio batch for the on-device mel (the trainers'
    `on_device_mel=True`): audio zero-padded to the frame-bucket boundary,
    no host mel."""
    audio, mel_lens = _bucket_audio(samples, pad_frame_multiple)
    return {"audio": audio, "mel_len": mel_lens, "transcript": _collate_transcripts(samples)}


def make_training_pipeline(
    samples: Stream,
    batch_size: int,
    epochs: int = 1,
    shuffle_buffer: int = 500,
    num_threads: int = 6,
    prefetch_size: int | None = None,
    pad_frame_multiple: int = 256,
    seed: int | None = None,
    drop_remainder: bool = True,
    on_device_mel: bool = False,
    shard_by_process: bool = False,
) -> Stream:
    """repeat -> shuffle -> [process shard] -> threaded decode -> batch (pad
    to a multiple of `pad_frame_multiple` frames) -> prefetch.
    `drop_remainder` keeps every batch full. `on_device_mel=True` yields
    raw-audio batches (pass on_device_mel=True to F5TTSTrainer.train too).

    shard_by_process=True: `batch_size` is the global batch and each process
    yields only its `process_local_batch_slice` of every global batch,
    decoding only its own items. It needs a seed (the stream before the
    shard must be the same on every process) and a global batch that the
    process count divides, and a clip that fails to decode raises."""
    from f5_tts_tpu_torch.data.libritts import decode_sample
    from f5_tts_tpu_torch.parallel import distributed as D

    stream = samples.repeat(epochs).shuffle(shuffle_buffer, seed=seed)
    local_batch = batch_size
    if shard_by_process:
        if seed is None:
            raise ValueError(
                "shard_by_process requires a seed: every process must see the "
                "same shuffled order for the batch slices to partition it"
            )
        if batch_size % D.process_count():
            raise ValueError(
                f"global batch {batch_size} is not divisible by process_count={D.process_count()}"
            )
        sl = D.process_local_batch_slice(batch_size)
        stream = stream.shard(batch_size, sl)
        local_batch = sl.stop - sl.start

    decode = decode_sample
    if shard_by_process:
        # the shard comes before decode, so a silently dropped sample would
        # shift this process's batches against its peers' and leave them
        # with unequal step counts: a deadlock in the collectives
        def decode(item, _decode=decode_sample):
            y = _decode(item)
            if y is None:
                raise RuntimeError(
                    f"decode failed for {item!r} under shard_by_process: a "
                    "silently skipped sample would desynchronize per-process "
                    "batch streams (peers would run unequal step counts and "
                    "deadlock); fix or exclude the file on every host"
                )
            return y

    collate = collate_raw_audio_batch if on_device_mel else collate_audio_batch
    return (
        stream.map(decode, num_threads=num_threads)
        .batch(local_batch, lambda b: collate(b, pad_frame_multiple), drop_remainder=drop_remainder)
        .prefetch(prefetch_size or 2)
    )
