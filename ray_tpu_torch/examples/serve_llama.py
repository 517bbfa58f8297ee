"""BASELINE config 5: Llama continuous-batching serving (counterpart of
``examples/serve_llama.py``; the debug model).

The continuous-batching engine (``ray_tpu_torch.llm.engine``: a paged KV
pool, bucketed prefill, batched decode through the paged kernel) behind a
serve deployment, and the HTTP proxy in front of it.

Run on the card:
  python -m ray_tpu_torch.examples.serve_llama
  python -m ray_tpu_torch.examples.serve_llama --load   # open-loop burst +
                                                        # SLO report
On the CPU: add ``--device cpu``.
"""

import argparse
import dataclasses
import json
import urllib.request

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.llm import LLMConfig, build_llm_app
from ray_tpu_torch.llm.serving import join_engine_threads
from ray_tpu_torch.models import LlamaConfig


def demo(handle):
    """One request through the handle, then one over HTTP."""
    out = handle.remote({"prompt": "hello tpu", "max_tokens": 8}).result()
    print("handle:", {k: out[k] for k in ("text", "finish_reason",
                                          "ttft_s")})

    port = serve.start_http_proxy(port=0)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/",
        data=json.dumps({"prompt": "hi", "max_tokens": 4}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        print("http:", json.loads(resp.read())["finish_reason"])
    return out


def load(handle, rate: float, duration: float, clients: int):
    """An open-loop burst through loadgen: the offered rate's requests/s,
    TTFT/E2E percentiles and goodput under an SLO."""
    from ray_tpu_torch.loadgen import (SLO, HandleTarget, LoadSpec,
                                       format_report, run_load)

    handle.remote({"prompt": [1] * 8, "max_tokens": 2}).result()   # warm
    spec = LoadSpec(rate=rate, duration_s=duration, clients=clients,
                    prompt_len="uniform:8:24", output_len=8, seed=0,
                    slo=SLO(ttft_s=1.0, e2e_s=5.0))
    report = run_load(HandleTarget(handle, stream=True), spec)
    print(format_report(report))
    return report


def main(argv=()):
    # default (): callable from tests without taking pytest's argv
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--load", action="store_true",
                        help="run a short open-loop burst and print the "
                             "SLO report instead of the single requests")
    parser.add_argument("--rate", type=float, default=10.0)
    parser.add_argument("--duration", type=float, default=3.0)
    parser.add_argument("--clients", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="the card by default; 'cpu' off it")
    args = parser.parse_args(list(argv))

    ray_tpu_torch.init(num_nodes=1, ignore_reinit_error=True)
    model = dataclasses.replace(LlamaConfig.debug(vocab_size=512,
                                                  max_seq_len=256),
                                decode_attention="kernel")
    app = build_llm_app(LLMConfig(model_id="llama-demo", model_config=model,
                                  max_slots=4, max_seq=256),
                        device=args.device)
    handle = serve.run(app)
    try:
        out = (load(handle, args.rate, args.duration, args.clients)
               if args.load else demo(handle))
    finally:
        serve.shutdown()
        join_engine_threads()
    return out


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
