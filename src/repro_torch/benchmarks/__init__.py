"""Runs of the port's paths: the SkyQuery cell (``skyquery``) and the
kill -9 recovery drill of the service daemon (``smoke_recovery``)."""
