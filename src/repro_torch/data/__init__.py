from repro_torch.data.lm_data import SyntheticLMDataset, batch_for

__all__ = ["SyntheticLMDataset", "batch_for"]
