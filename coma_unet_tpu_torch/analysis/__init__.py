"""Model introspection of the port (counterpart of `coma_unet_tpu/analysis/`):
the attention maps' export. The embedding probe and the regional analysis
are not ported yet."""

from coma_unet_tpu_torch.analysis.attention import export_attention_maps  # noqa: F401
