"""Serving latency on the card: the port of the live part of the JAX
package's `tools/serve_latency.py`.

    PYTHONPATH=. python -m f5_tts_tpu_torch.tools.serve_latency [--model <snapshot dir>]

Starts the HTTP server in this process on the base DiT (random weights from
`--seed`, bf16, with Vocos) or on a snapshot directory, runs `warmup` for
the buckets and batch sizes it times, then `measure`s:

  - warm_synthesize_s: the median of 5 warm POST /synthesize of a 7 s
    utterance, RK4 at 8 steps;
  - stream_ttfa_s: the time to the first PCM bytes of a warm 4-sentence
    /synthesize_stream (durations by the text-length heuristic, as the JAX
    tool's model, which has no duration predictor, resolves them);
  - mixed_load_small_request_s: a 5 s request sent 0.25 s into a burst of
    three 9 s requests, beside its idle baseline.

Prints one JSON line per metric, each with the card's name. The device must
be a CUDA device.

`--artifact-bench` measures the artifact server's micro-batching instead
(the JAX tool's counterpart): it exports batch-1 and batch-4 sampler
artifacts of the same model (7 s bucket, RK4 at 8 steps, external
weights), serves them, and `artifact_measure`s 8 sequential requests
against 8 concurrent ones, once on a batch-1-only server (the control: no
grouping possible) and once on the batch-1 + batch-4 deployment:
artifact_throughput_sequential_utt_s and
artifact_throughput_concurrent_{b1only,b1b4}_utt_s.
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time
import urllib.request

import numpy as np

SAMPLER = {"steps": 8, "method": "rk4", "seed": 0}  # every request's, and the warm-up's
WARM_RUNS = 5
STREAM_TEXT = ("The first sentence streams immediately. Then a second one follows. "
               "A third continues the story. And a fourth concludes it.")


def post(port: int, payload: dict, path: str = "/synthesize", timeout: float = 600.0):
    """POST `payload` as JSON; a status other than 200 raises HTTPError."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    return urllib.request.urlopen(req, timeout=timeout)


def measure(port: int) -> dict:
    """The three latencies, in seconds, on the running, warmed server at
    `port`. Any failed request raises."""
    times = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        with post(port, dict(SAMPLER, text="a warm latency probe request", duration=7.0)) as r:
            r.read()
        times.append(time.perf_counter() - t0)
    warm = statistics.median(times)

    stream_payload = dict(SAMPLER, text=STREAM_TEXT, estimate_duration=True)
    for _ in range(2):  # the first run pays what the warm-up left
        t0 = time.perf_counter()
        with post(port, stream_payload, path="/synthesize_stream") as r:
            r.read(44)  # the WAV stream header
            if len(r.read(2)) != 2:  # the first PCM bytes of sentence 0
                raise RuntimeError("the stream ended before its first PCM bytes")
            ttfa = time.perf_counter() - t0
            r.read()
            total = time.perf_counter() - t0

    burst_done, errors = [], []

    def burst(i):
        try:
            with post(port, dict(SAMPLER, text=f"long backfill request number {i}", duration=9.0)) as r:
                r.read()
            burst_done.append(time.perf_counter())
        except Exception as e:  # re-raised below: a dead thread would shorten the burst
            errors.append(e)

    threads = [threading.Thread(target=burst, args=(i,)) for i in range(3)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(0.25)  # land while the burst's group runs
    t0 = time.perf_counter()
    with post(port, dict(SAMPLER, text="urgent small request", duration=5.0)) as r:
        r.read()
    small = time.perf_counter() - t0
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"burst requests failed: {errors or 'join timeout'}")
    return {
        "warm_synthesize_s": warm,
        "warm_runs_s": times,
        "stream_ttfa_s": ttfa,
        "stream_total_s": total,
        "mixed_load_small_request_s": small,
        "idle_baseline_s": warm,
        "added_s": small - warm,
        "burst_total_s": max(burst_done) - t_start,
    }


ARTIFACT_PAYLOAD = {"text": "an artifact serving throughput probe request", "duration": 7.0, "seed": 0}


def artifact_measure(port: int, n_requests: int = 8, sequential: bool = True,
                     payload: dict = ARTIFACT_PAYLOAD) -> dict:
    """Utterances per second of `n_requests` requests (`payload`) sent one
    after another (with `sequential`), then all at once, to the running,
    warmed artifact server at `port`. Any failed or hung request raises."""

    def one(i):
        with post(port, payload) as r:
            r.read()

    one(-1)  # what the warm-up left (a first HTTP connection, the host buffers)
    out = {}
    if sequential:
        t0 = time.perf_counter()
        for i in range(n_requests):
            one(i)
        seq = time.perf_counter() - t0
        out.update(sequential_utt_s=n_requests / seq, sequential_total_s=seq)
    errors = []

    def worker(i):
        try:
            one(i)
        except Exception as e:  # re-raised below: a dead thread would inflate the rate
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_requests)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    conc = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"concurrent requests failed: {errors or 'join timeout'}")
    out.update(concurrent_utt_s=n_requests / conc, concurrent_total_s=conc)
    return out


def artifact_bench(model, tmp: str, n_requests: int = 8) -> dict:
    """Export batch-1 and batch-4 artifacts of `model` into `tmp` and
    measure both server configurations; prints and returns the metrics."""
    import torch

    from f5_tts_tpu_torch import export as E
    from f5_tts_tpu_torch.artifact_serve import serve_artifacts

    frames = int(ARTIFACT_PAYLOAD["duration"] * model.audio_cfg.frames_per_second)
    bucket = model.cfm_cfg.duration_bucket
    padded = -(-frames // bucket) * bucket
    card = torch.cuda.get_device_name(model.device)
    paths = []
    for b in (1, 4):
        t0 = time.perf_counter()
        exp = E.export_sampler(model, batch=b, padded_len=padded, steps=SAMPLER["steps"], method=SAMPLER["method"],
                               embed_weights=False)
        path = f"{tmp}/b{b}.bin"
        E.save_sampler(exp, path, model=model, extra_meta={"method": SAMPLER["method"], "cfg_strength": 2.0})
        paths.append(path)
        print(json.dumps({"metric": f"export_b{b}_s", "value": time.perf_counter() - t0, "device": card}))
    sr = model.audio_cfg.sample_rate
    ref = (0.1 * np.sin(2 * np.pi * 220 * np.arange(2 * sr) / sr)).astype(np.float32)
    metrics = {}
    for label, art_paths in (("b1only", paths[:1]), ("b1b4", paths)):
        httpd = serve_artifacts(art_paths, default_ref=(ref, "a throughput probe reference"), host="127.0.0.1",
                                port=0, max_wait_ms=100.0, device=model.device)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            httpd.sampler.warmup()
            r = artifact_measure(httpd.server_address[1], n_requests, sequential="sequential" not in metrics)
        finally:
            httpd.batcher.stop()
            httpd.shutdown()
        if "sequential_utt_s" in r:
            metrics["sequential"] = r["sequential_utt_s"]
            print(json.dumps({"metric": "artifact_throughput_sequential_utt_s", "value": r["sequential_utt_s"],
                              "total_s": r["sequential_total_s"], "device": card}))
        metrics[label] = r["concurrent_utt_s"]
        print(json.dumps({"metric": f"artifact_throughput_concurrent_{label}_utt_s", "value": r["concurrent_utt_s"],
                          "total_s": r["concurrent_total_s"],
                          "speedup_vs_sequential": r["concurrent_utt_s"] / metrics["sequential"], "device": card}))
    return metrics


def _base_model(device, seed: int):
    import torch

    from f5_tts_tpu_torch import F5TTS, CFMConfig, Vocos, VocosConfig
    from f5_tts_tpu_torch.config import F5TTS_V1_BASE

    gen = torch.Generator(device=device).manual_seed(seed)
    return F5TTS.init(gen, F5TTS_V1_BASE.replace(compute_dtype="bfloat16"), device=device, cfm_cfg=CFMConfig(),
                      vocoder=Vocos.init(gen, VocosConfig(compute_dtype="bfloat16"), device=device))


def main(argv: list[str] | None = None) -> dict:
    import torch

    from f5_tts_tpu_torch.generate import load_model
    from f5_tts_tpu_torch.serve import serve, warmup
    from f5_tts_tpu_torch.tools._timing import cuda_device

    ap = argparse.ArgumentParser(description="serving latency of the PyTorch package on the card")
    ap.add_argument("--model", default=None, help="snapshot directory (default: the base DiT, random weights)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--artifact-bench", action="store_true",
                    help="the artifact server's sequential against concurrent throughput instead")
    args = ap.parse_args(argv)
    device = cuda_device(args.device)
    model = _base_model(device, args.seed) if args.model is None else load_model(args.model, None, str(device))
    if args.artifact_bench:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            return artifact_bench(model, tmp)
    httpd = serve(model, host="127.0.0.1", port=0, max_batch=8, max_wait_ms=30.0)
    try:
        warmup(model, [5.0, 7.0, 9.0], steps=SAMPLER["steps"], method=SAMPLER["method"], batch_sizes=(1, 2, 3),
               batcher=httpd.batcher)
        result = measure(httpd.server_address[1])
    finally:
        httpd.batcher.stop()
        httpd.shutdown()
    card = torch.cuda.get_device_name(device)
    for name, extra in (("warm_synthesize_s", ("warm_runs_s",)), ("stream_ttfa_s", ("stream_total_s",)),
                        ("mixed_load_small_request_s", ("idle_baseline_s", "added_s", "burst_total_s"))):
        print(json.dumps({"metric": name, "value": result[name], **{k: result[k] for k in extra}, "device": card}))
    return result


if __name__ == "__main__":
    main()
