from cu2rec_torch.models.state import (
    COMPONENTS, MFModel, init_model, initialize_normal, model_to_numpy,
)

__all__ = ["MFModel", "init_model", "initialize_normal", "model_to_numpy",
           "COMPONENTS"]
