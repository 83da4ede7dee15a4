from tpukernels_torch.utils.shapes import cdiv, pick_device

__all__ = ["cdiv", "pick_device"]
