"""One runner per kind of traffic: its set-up, its unit of work and its
check against the plain reference.  A traffic file's ``runner`` key
names the module."""
