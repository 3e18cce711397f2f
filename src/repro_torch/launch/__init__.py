"""Launchers: the training CLI and its restart supervisor."""
