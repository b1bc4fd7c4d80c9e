"""One module a traffic ``kind``, as a traffic file names it. Each module
gives ``setup``, ``window``, ``end_to_end``, ``release`` and ``check``."""
