"""One driver a traffic kind: ``drivers/<kind>.py`` defines ``Run``."""
