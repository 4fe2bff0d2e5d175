"""Serving example over the PyTorch/CUDA port: batched decode with TEDA
stream monitoring on the "cuda" monitor (the steps of
`serve_monitored.py`, over `repro_torch`).

    PYTHONPATH=src python examples/torch_serve_monitored.py      # GPU
    PYTHONPATH=src python examples/torch_serve_monitored.py --device cpu

The weights and prompts are drawn from seed 0 on the port's generators,
which are not the JAX package's: the tokens differ from the twin's, the
flagged requests do not.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.engine.engine import resolve_device
from repro_torch.launch.serve import serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "monitor kernel's plain PyTorch version)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = get_config("qwen2-7b").reduced()
    res = serve(cfg, batch=4, prompt_len=24, gen=24, backend="cuda",
                device=dev)
    print(f"prefill: {res['prefill_tok_s']:.1f} tok/s, "
          f"decode: {res['decode_tok_s']:.1f} tok/s")
    print(f"TEDA-flagged requests: {res['flagged_requests']}")
    assert res["tokens"].shape == (4, 24)
    print("OK")


if __name__ == "__main__":
    main()
