"""Online CP core of the port (``online``) and the engines' host-side
bookkeeping (``engine_utils``)."""
