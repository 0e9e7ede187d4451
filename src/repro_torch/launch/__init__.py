"""Launchers of the port: the serve loop (:mod:`.serve`)."""
