"""The recipe's drivers, each run with ``python -m``:

- ``make_lf_fixture``: the flagship config, seeded blank-biased weights
  and synthetic long-form episodes;
- ``run_accuracy_loop``: make_shard -> compute_cmvn_stats -> recognize_wav
  + WER at init -> bin/train -> recognize_wav + WER;
- ``run_impl_matrix``: transcript equality across the CLI's code paths;
- ``run_lf_sweep``: the long-form chunk-size WER sweep;
- ``run_rtf_sweep``: one bin/encoder_rtf subprocess per (model, batch,
  chunk), tabled by tools/rtf_tables.

Each calls the port's CLIs and runs on ``cuda`` unless given ``--device
cpu``.
"""
import os

# the repository root: the recipe's configs are read from
# <root>/examples/gigaspeech/conf/
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), *[".."] * 4))
CONF_DIR = os.path.join(REPO, "examples", "gigaspeech", "conf")


def run_cli(mod: str, argv) -> None:
    """Run ``bin/<mod>.py``'s ``main`` in this process (the kernels, once
    built and loaded, serve every call); a non-zero return raises."""
    import importlib

    main = importlib.import_module(
        f"paper_accurate_fast_cheap_tpu_torch.bin.{mod}").main
    rc = main([str(a) for a in argv])
    if rc:
        raise RuntimeError(f"{mod} failed rc={rc}")
