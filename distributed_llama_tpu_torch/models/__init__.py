from .spec import ArchType, HiddenAct, ModelSpec

__all__ = ["ArchType", "HiddenAct", "ModelSpec"]
