from .fixtures import make_gradient_clip, make_synthetic_frames

__all__ = ["make_gradient_clip", "make_synthetic_frames"]
