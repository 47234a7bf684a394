from adfmsl_torch.models.mazes import SPECS, MazeModel, MazeSpec, build_model
from adfmsl_torch.models.port import (load_checkpoint, save_checkpoint,
                                      state_dict_from_flax)

__all__ = ["SPECS", "MazeModel", "MazeSpec", "build_model", "load_checkpoint",
           "save_checkpoint", "state_dict_from_flax"]
