from .config import SolverConfig, default_chunk_size, resolve_tri_mode

__all__ = ["SolverConfig", "default_chunk_size", "resolve_tri_mode"]
