"""The example CLIs of the port, one module per script of the JAX package's
``examples/``, each run as ``python -m spfresh_tpu_torch.examples.<name>``
(``build_index``, ``load_index``, ``live_updates``, ``disk_updates``,
``quantized_index``, ``sharded_search``, ``sift_eval``).

Each has ``main(argv=None)``, does no work at import, takes ``--device``
(default ``"cuda"``, which raises where there is no card; ``--device cpu``
runs on the CPU) and prints the JAX script's lines after a first line that
names the device.  Stores and indexes go to temporary directories, except
``build_index``/``load_index``, which keep the example config's relative
``output_path: "data"`` in the working directory.
"""

import argparse

import torch

from spfresh_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' ``--device`` option."""
    ap = argparse.ArgumentParser(description=doc.strip().split("\n\n")[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device to run on (default: cuda; cpu runs the plain versions)")
    return ap


def start(args) -> torch.device:
    """Resolve ``args.device`` (raising where CUDA is asked for and absent)
    and print the first line."""
    device = resolve_device(args.device)
    print(f"device: {device}")
    return device
