"""One module a traffic kind, named by the traffic file's ``driver``."""
