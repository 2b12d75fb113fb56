from .factory import MODEL_FACTORY, build_model

__all__ = ["MODEL_FACTORY", "build_model"]
