"""Checkpoint IO."""
