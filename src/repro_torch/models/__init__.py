from repro_torch.models.api import ModelBundle, build_model, params_to

__all__ = ["ModelBundle", "build_model", "params_to"]
