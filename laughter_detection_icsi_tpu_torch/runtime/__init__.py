"""Native (C++) host runtime: audio decode and the PCM packer."""
