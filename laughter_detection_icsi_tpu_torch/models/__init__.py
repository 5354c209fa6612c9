"""The model zoo as nn.Modules, and shared-stem window inference."""
