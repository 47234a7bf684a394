from adfmsl_torch.models.mazes import (EXTRAS, SPECS, MazeModel, MazeSpec, build_model,
                                       model_registry)
from adfmsl_torch.models.port import (load_checkpoint, load_torch_state_dict, merge,
                                      port_maze_state_dict, reference_parity_experiment,
                                      save_checkpoint, state_dict_from_flax)

__all__ = ["EXTRAS", "SPECS", "MazeModel", "MazeSpec", "build_model", "load_checkpoint",
           "load_torch_state_dict", "merge", "model_registry", "port_maze_state_dict",
           "reference_parity_experiment", "save_checkpoint", "state_dict_from_flax"]
