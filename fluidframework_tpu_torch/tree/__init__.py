from fluidframework_tpu_torch.tree import marks  # noqa: F401
from fluidframework_tpu_torch.tree.edit_manager import Commit, EditManager  # noqa: F401
from fluidframework_tpu_torch.tree.shared_tree import SharedTree  # noqa: F401
