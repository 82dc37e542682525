"""The model stack's serving path: config schema (``config``), layers
(``layers``), the stack and ``serve_step`` (``model``), and params to and
from the JAX package's numpy form (``convert``)."""
