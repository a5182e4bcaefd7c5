"""The streaming tracker."""
