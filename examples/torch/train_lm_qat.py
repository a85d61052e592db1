"""Train a ~100M LM with the FIXAR technique as a first-class feature:
fixed-point weight/gradient memories + dynamic activation quantization,
checkpointing included — the end-to-end driver, on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch/train_lm_qat.py          # ~100M, on the card
    PYTHONPATH=src python examples/torch/train_lm_qat.py --smoke  # tiny, seconds
    PYTHONPATH=src python examples/torch/train_lm_qat.py --smoke --device cpu

The port of `examples/train_lm_qat.py`: the same sizes (demo-100m, 300
steps of B = 2, S = 256, the QAT delay at 150; `--smoke` 60 steps of B = 4,
S = 64 at the smoke config, delay 30) through the port's train CLI
(`repro_torch.launch.train`).  Checkpoints go to `results/fixar_lm_ckpt`
(the reference writes `/tmp/fixar_lm_ckpt`), or under `out_dir=`.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

from repro_torch.device import resolve_device
from repro_torch.launch import train as train_driver

RESULTS = pathlib.Path(__file__).resolve().parents[2] / "results"


def main(device=None, *, smoke=False, steps=None, batch=None, seq=None, qat_delay=None, ckpt_every=50,
         log_every=10, out_dir=None):
    """Run the driver as the reference does (`steps`, `batch`, `seq`,
    `qat_delay` default to its sizes); returns (the final `TrainState`, the
    logged records, the checkpoint directory)."""
    dev = resolve_device(device)
    ckpt_dir = (pathlib.Path(out_dir) if out_dir is not None else RESULTS) / "fixar_lm_ckpt"
    argv = [
        "--arch", "demo_100m",
        "--steps", str(steps if steps is not None else 60 if smoke else 300),
        "--batch", str(batch if batch is not None else 4 if smoke else 2),
        "--seq", str(seq if seq is not None else 64 if smoke else 256),
        "--qat", "--qat-delay", str(qat_delay if qat_delay is not None else 30 if smoke else 150),
        "--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(ckpt_every),
        "--log-every", str(log_every),
        "--device", dev.type,
    ]
    if smoke:
        argv.append("--smoke")
    state, records = train_driver.main(argv)
    return state, records, ckpt_dir


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.device, smoke=args.smoke)
