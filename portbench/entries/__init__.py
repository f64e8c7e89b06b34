"""The benchmark's entries, one file each, found by the name that a traffic
file gives as its ``entry`` (spec.py's ``entry``): ``<name>.py`` exports
the entry's class as ``Entry``. A cell that needs a new entry is a new file
here; run.py's shell drives every entry alike."""
