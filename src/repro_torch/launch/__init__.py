"""Launchers of the port: the serve loop (:mod:`.serve`) and the trainer
(:mod:`.train`)."""
