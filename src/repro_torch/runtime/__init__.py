"""Distributed runtime: device resolution and the ``DistContext`` handle."""
