"""One module a case, named after it, that builds the case's geometry."""
