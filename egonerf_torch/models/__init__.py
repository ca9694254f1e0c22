"""Models of the port: EgoNeRF with MLP_Fea shading, and the converter for
JAX checkpoints.  The TensoRF family waits (ROADMAP.md §1)."""
from .convert import load_jax_checkpoint, params_from_jax, params_to_jax
from .egonerf import EgoNeRF, FieldConfig, LookupTables, feature2density
from .shading import MLPFea
