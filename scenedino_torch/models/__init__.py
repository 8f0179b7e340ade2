"""models of the PyTorch port."""
from scenedino_torch.models.field import EncoderDummy, FieldConfig, SceneField, SceneState  # noqa: F401
from scenedino_torch.models.heads import ImplicitNet, ResnetFC, make_head  # noqa: F401
