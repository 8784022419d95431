"""Command-line interface of the port: `python -m
coma_unet_tpu_torch.cli.main {train,validate,infer}`."""

from coma_unet_tpu_torch.cli.main import build_parser, main  # noqa: F401
