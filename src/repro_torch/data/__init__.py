from .pipeline import (SyntheticLMDataset, DataLoader, batch_specs,
                       make_batch, to_device)

__all__ = ["SyntheticLMDataset", "DataLoader", "batch_specs", "make_batch",
           "to_device"]
