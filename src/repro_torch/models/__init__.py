from repro_torch.models.registry import Model, ModelSettings, build_model, count_params

__all__ = ["Model", "ModelSettings", "build_model", "count_params"]
