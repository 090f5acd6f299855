"""Region-attention editing (counterpart of where2edit_tpu/editing): the
mapper family, k-means regions and the attention-map post-processing."""

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
from where2edit_tpu_torch.editing.masks import (
    finalize_attention_map,
    straight_through_threshold,
)

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
    "MapperConLinNet",
    "MapperConNet",
    "MapperNet",
    "MapperOutput",
    "assign_clusters",
    "cluster_features",
    "kmeans_fit",
    "straight_through_threshold",
    "finalize_attention_map",
]
