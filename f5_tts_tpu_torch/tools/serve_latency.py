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
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time
import urllib.request

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
    args = ap.parse_args(argv)
    device = cuda_device(args.device)
    model = _base_model(device, args.seed) if args.model is None else load_model(args.model, None, str(device))
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
