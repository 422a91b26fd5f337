from .svd import SVD, SVDWhich

__all__ = ["SVD", "SVDWhich"]
