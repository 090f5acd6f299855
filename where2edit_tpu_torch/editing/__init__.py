"""Region-attention editing (counterpart of where2edit_tpu/editing): the
mapper family, k-means regions, the attention-map post-processing and the
StyleCLIP latent mappers."""

from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapper,
    FullSpaceMapperAtt,
    FullSpaceMapperAttLin,
    FullSpaceMapperAttLinStyle,
    FullSpaceMapperCon,
    FullSpaceMapperFEATClusterLin,
    FullSpaceMapperFEATClusterLinStyle,
    FullSpaceMapperFEATLin,
    FullSpaceMapperFEATLinStyle,
    FullSpaceMapperSpatialLin,
    MapperConLinNet,
    MapperConNet,
    MapperNet,
    MapperOutput,
)
from where2edit_tpu_torch.editing.clustering import (
    assign_clusters,
    cluster_features,
    kmeans_fit,
)
from where2edit_tpu_torch.editing.latent_mappers import (
    STYLESPACE_DIMENSIONS,
    STYLESPACE_INDICES_WITHOUT_TORGB,
    FullStyleSpaceMapper,
    LevelsMapper,
    Mapper,
    SingleMapper,
    WithoutToRGBStyleSpaceMapper,
    stylespace_count,
)
from where2edit_tpu_torch.editing.masks import (
    finalize_attention_map,
    straight_through_threshold,
)
from where2edit_tpu_torch.editing.styleclip_mapper import StyleCLIPMapper, build_mapper

__all__ = [
    "FullSpaceMapper",
    "FullSpaceMapperAtt",
    "FullSpaceMapperAttLin",
    "FullSpaceMapperAttLinStyle",
    "FullSpaceMapperCon",
    "FullSpaceMapperFEATClusterLin",
    "FullSpaceMapperFEATClusterLinStyle",
    "FullSpaceMapperFEATLin",
    "FullSpaceMapperFEATLinStyle",
    "FullSpaceMapperSpatialLin",
    "FullStyleSpaceMapper",
    "LevelsMapper",
    "Mapper",
    "MapperConLinNet",
    "MapperConNet",
    "MapperNet",
    "MapperOutput",
    "STYLESPACE_DIMENSIONS",
    "STYLESPACE_INDICES_WITHOUT_TORGB",
    "SingleMapper",
    "StyleCLIPMapper",
    "WithoutToRGBStyleSpaceMapper",
    "assign_clusters",
    "build_mapper",
    "cluster_features",
    "kmeans_fit",
    "straight_through_threshold",
    "finalize_attention_map",
    "stylespace_count",
]
