"""Input admission."""
