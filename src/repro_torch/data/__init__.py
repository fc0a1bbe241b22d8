from .pipeline import (DataPipelineConfig, ShardedTokenDataset,
                       TokenShardWriter, synthetic_corpus)

__all__ = ["DataPipelineConfig", "ShardedTokenDataset", "TokenShardWriter",
           "synthetic_corpus"]
