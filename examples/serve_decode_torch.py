"""Serving example on the PyTorch port: batched incremental decoding with a
KV cache; the port's copy of ``examples/serve_decode.py``.

Initializes a reduced gemma3-family model (``get_config("gemma3-1b")
.reduced()``: two local-window layers over a 32-slot ring), steps a prompt
batch through the cache, then greedily generates tokens.  Decode is plain
PyTorch and reaches no kernel, as in the reference.  It runs on the card
(``--device cuda``, the default); ``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models.model import Model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("gemma3-1b").reduced()
    model = Model(cfg, device=args.device)
    dev = model.device
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))

    B, prompt_len, gen_len = 4, 16, 24
    max_len = prompt_len + gen_len
    prompt = torch.randint(0, cfg.vocab_size, (B, prompt_len),
                           generator=torch.Generator(device=dev).manual_seed(1), device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cache = model.init_cache(B, max_len)

    # prefill by stepping the prompt through the cache
    t0 = time.time()
    logits = None
    for t in range(prompt_len):
        logits, cache = model.decode_step(params, cache, prompt[:, t:t + 1], t)
    sync()
    print(f"prefill {prompt_len} tokens x {B} seqs: {time.time() - t0:.2f}s")

    # greedy decode, the next token kept on the device
    t0 = time.time()
    out = []
    tok = logits.argmax(-1, keepdim=True)
    for t in range(prompt_len, max_len):
        out.append(tok)
        logits, cache = model.decode_step(params, cache, tok, t)
        tok = logits.argmax(-1, keepdim=True)
    gen = torch.cat(out, dim=1).cpu()
    dt = time.time() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    print(f"generated {gen_len} tokens x {B} seqs: {dt:.2f}s "
          f"({B * gen_len / dt:.1f} tok/s on {name})")
    print("sample token ids:", gen[0, :12].tolist())


if __name__ == "__main__":
    main()
