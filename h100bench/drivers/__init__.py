"""One driver per kind of traffic (``batch``, ``single``, ``stream``,
``train``), each with the same five steps: ``setup``, ``window``,
``profile``, ``release`` and ``check``."""
