/* Header-only C++ class API for custom filters.
 *
 * The analog of NNStreamer's custom-C++ class backend
 * (tensor_filter_cpp.h: an abstract class with getInputDim/getOutputDim/
 * invoke virtuals and static registration); the port's copy of the JAX
 * package's header.
 * Here the class rides the existing C ABI (nns_custom_filter.h): subclass
 * nns::Filter, register with NNS_REGISTER_FILTER, compile to a .so, and
 * load it with `tensor_filter framework=custom-so model=libmyfilter.so` —
 * no free-function exports to write by hand.
 *
 *   #include "nns_filter.hh"
 *   class Doubler : public nns::Filter {
 *     int get_input_spec(nns_tensors_spec *s) override { ... }
 *     int get_output_spec(nns_tensors_spec *s) override { ... }
 *     int invoke(const void *const *in, const uint64_t *in_sz,
 *                void *const *out, const uint64_t *out_sz) override { ... }
 *   };
 *   NNS_REGISTER_FILTER(Doubler)
 *
 *   g++ -O2 -std=c++17 -shared -fPIC doubler.cc -o libdoubler.so
 */

#ifndef NNS_FILTER_HH
#define NNS_FILTER_HH

#include <initializer_list>
#include <memory>

#include "nns_custom_filter.h"

namespace nns {

class Filter {
 public:
  virtual ~Filter () = default;

  /* Negotiation (getInputDimension / getOutputDimension analogs). */
  virtual int get_input_spec (nns_tensors_spec *spec) = 0;
  virtual int get_output_spec (nns_tensors_spec *spec) = 0;

  /* Per-frame work: write into preallocated out buffers.  Return 0 on
   * success, >0 to drop the frame, <0 on error. */
  virtual int invoke (const void *const *in_bufs, const uint64_t *in_sizes,
                      void *const *out_bufs, const uint64_t *out_sizes) = 0;

  /* Optional lifecycle (the custom= property arrives here). */
  virtual int init (const char *custom) {
    (void) custom;
    return 0;
  }

  /* Convenience: fill one tensor slot of a spec. */
  static void set_tensor (nns_tensors_spec *spec, uint32_t index,
                          int32_t dtype, std::initializer_list<uint64_t> dims) {
    nns_tensor_spec &t = spec->tensors[index];
    t.dtype = dtype;
    t.rank = 0;
    for (uint64_t d : dims)
      t.dims[t.rank++] = d;
    if (index + 1 > spec->num_tensors)
      spec->num_tensors = index + 1;
  }
};

namespace detail {
/* The registered instance; created by the macro's factory on first use. */
inline std::unique_ptr<Filter> &instance () {
  static std::unique_ptr<Filter> inst;
  return inst;
}
inline Filter *(*&factory ()) () {
  static Filter *(*fn) () = nullptr;
  return fn;
}
inline Filter *get () {
  auto &inst = instance ();
  if (!inst && factory () != nullptr)
    inst.reset (factory () ());
  return inst.get ();
}
}  // namespace detail

}  // namespace nns

/* Registration: defines the C ABI exports (nns_custom_filter.h) delegating
 * to a lazily-constructed singleton of the given class — the static-
 * registration analog of tensor_filter_cpp.h's class_register. */
#define NNS_REGISTER_FILTER(ClassName)                                        \
  static const bool nns_registered_##ClassName = [] {                         \
    nns::detail::factory () = [] () -> nns::Filter * {                        \
      return new ClassName ();                                                \
    };                                                                        \
    return true;                                                              \
  }();                                                                        \
  extern "C" int nns_init (const char *custom) {                              \
    nns::Filter *f = nns::detail::get ();                                     \
    return f ? f->init (custom) : -1;                                         \
  }                                                                           \
  extern "C" int nns_get_input_spec (nns_tensors_spec *spec) {                \
    nns::Filter *f = nns::detail::get ();                                     \
    return f ? f->get_input_spec (spec) : -1;                                 \
  }                                                                           \
  extern "C" int nns_get_output_spec (nns_tensors_spec *spec) {               \
    nns::Filter *f = nns::detail::get ();                                     \
    return f ? f->get_output_spec (spec) : -1;                                \
  }                                                                           \
  extern "C" int nns_invoke (const void *const *in_bufs,                      \
      const uint64_t *in_sizes, void *const *out_bufs,                        \
      const uint64_t *out_sizes) {                                            \
    nns::Filter *f = nns::detail::get ();                                     \
    return f ? f->invoke (in_bufs, in_sizes, out_bufs, out_sizes) : -1;       \
  }                                                                           \
  extern "C" void nns_destroy (void) { nns::detail::instance ().reset (); }

#endif /* NNS_FILTER_HH */
