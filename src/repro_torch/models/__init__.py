"""LM stack of the port: the dense and vlm families (GQA transformer
blocks), the MoE family with MLA attention (DeepSeek-V2), the ssm family
(Mamba-2) and the hybrid family (Zamba2)."""
from .common import ArchConfig, Mesh
from .lm import Model

__all__ = ["ArchConfig", "Mesh", "Model"]
