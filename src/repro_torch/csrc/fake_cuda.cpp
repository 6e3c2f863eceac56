// A stand-in CUDA device for a PyTorch built without CUDA, with no card.
//
// launch/dryrun.py traces the card's program on fake tensors (shapes, no
// storage) on "cuda" devices. Such a build lacks two things the trace
// needs: a CUDA device guard (indexing a tensor switches to its device
// through one) and CUDA hooks that say the device type is built (the
// autograd engine asks for the device's current stream in a backward).
// This library registers a guard that switches nothing, with one default
// stream whose events are no-ops, and hooks that report one device, both
// only where no CUDA guard is registered. Nothing here runs CUDA code or
// touches memory: a fake tensor holds none, and no real tensor can be
// made on the device (the build has no CUDA allocator). The hooks are
// read once, at their first use, so the library must be loaded before
// PyTorch is (LD_PRELOAD); loaded after, only the guard takes effect.
#include <ATen/detail/CUDAHooksInterface.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>

namespace {

constexpr auto kCuda = c10::DeviceType::CUDA;

bool registered() {
  return c10::impl::hasDeviceGuardImpl(kCuda);
}

struct FakeCudaGuard final : c10::impl::DeviceGuardImplInterface {
  c10::DeviceType type() const override { return kCuda; }
  c10::Device exchangeDevice(c10::Device) const override { return {kCuda, 0}; }
  c10::Device getDevice() const override { return {kCuda, 0}; }
  void setDevice(c10::Device) const override {}
  void uncheckedSetDevice(c10::Device) const noexcept override {}
  c10::Stream getStream(c10::Device) const noexcept override {
    return c10::Stream(c10::Stream::DEFAULT, c10::Device(kCuda, 0));
  }
  c10::Stream getDefaultStream(c10::Device d) const override {
    return getStream(d);
  }
  c10::Stream getNewStream(c10::Device d, int) const override {
    return getStream(d);
  }
  c10::Stream exchangeStream(c10::Stream s) const noexcept override {
    return getStream(s.device());
  }
  c10::DeviceIndex deviceCount() const noexcept override { return 1; }
  void destroyEvent(void*, const c10::DeviceIndex) const noexcept override {}
  void record(void**, const c10::Stream&, const c10::DeviceIndex,
              const c10::EventFlag) const override {}
  void block(void*, const c10::Stream&) const override {}
  bool queryEvent(void*) const override { return true; }
  bool queryStream(const c10::Stream&) const override { return true; }
  void synchronizeStream(const c10::Stream&) const override {}
  void synchronizeEvent(void*) const override {}
  void synchronizeDevice(const c10::DeviceIndex) const override {}
};

struct RegisterFakeCudaGuard {
  RegisterFakeCudaGuard() {
    if (!registered()) {
      static FakeCudaGuard guard;
      c10::impl::DeviceGuardImplRegistrar(kCuda, &guard);
    }
  }
} register_fake_cuda_guard;

}  // namespace

namespace at {
namespace fake_cuda {

// registered under the name the CUDA build's hooks take ("CUDAHooks")
struct CUDAHooks : CUDAHooksInterface {
  explicit CUDAHooks(CUDAHooksArgs) {}
  bool isBuilt() const override { return true; }
  bool isAvailable() const override { return true; }
  bool hasCUDA() const override { return true; }
  bool hasPrimaryContext(c10::DeviceIndex) const override { return false; }
  c10::DeviceIndex deviceCount() const override { return 1; }
  c10::DeviceIndex getCurrentDevice() const override { return 0; }
};

REGISTER_CUDA_HOOKS(CUDAHooks);

}  // namespace fake_cuda
}  // namespace at
