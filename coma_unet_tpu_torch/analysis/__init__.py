"""Model introspection and analysis of the port (counterpart of
`coma_unet_tpu/analysis/`): the attention maps' export, the embedding
probe and the per-ROI statistics."""

from coma_unet_tpu_torch.analysis.attention import export_attention_maps  # noqa: F401
from coma_unet_tpu_torch.analysis.embeddings import (  # noqa: F401
    extract_bottleneck_encodings,
    pca,
    probe_abeta_from_embeddings,
)
from coma_unet_tpu_torch.analysis.regions import (  # noqa: F401
    analyze_region,
    analyze_sample,
    create_roi_suvr_table,
)
