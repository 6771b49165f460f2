"""Model configurations ported so far (see ``registry``)."""
