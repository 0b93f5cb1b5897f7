"""Train steps of the port (:mod:`.steps`)."""
