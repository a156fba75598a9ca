"""The code of each traffic kind, one file each, found by a mix's ``kind``."""
