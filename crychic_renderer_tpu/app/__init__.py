from .renderer import Renderer


def use_compile_cache():
    """Keep JAX's persistent compilation cache for an entry point: where
    JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and nothing else
    is set; otherwise the fixed directory .jax_cache/ at the checkout's
    root (listed in .gitignore). Tests do not call this."""
    import os

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(root, ".jax_cache"))
