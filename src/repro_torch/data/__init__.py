from repro_torch.data.pipeline import SyntheticLMData, spectral_field

__all__ = ["SyntheticLMData", "spectral_field"]
