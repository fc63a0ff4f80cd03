"""Process identity and lifecycle (see :mod:`.basics`)."""
