from adfmsl_torch.models.mazes import (EXTRAS, SPECS, MazeModel, MazeSpec, build_model,
                                       model_registry)
from adfmsl_torch.models.port import (load_checkpoint, save_checkpoint,
                                      state_dict_from_flax)

__all__ = ["EXTRAS", "SPECS", "MazeModel", "MazeSpec", "build_model", "load_checkpoint",
           "model_registry", "save_checkpoint", "state_dict_from_flax"]
