"""The labelers of training mode: truth variants to example labels."""
